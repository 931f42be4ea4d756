"""The TAA kernel's roofline reader: its byte count (40 B a pixel: depth,
colour and the history in, the resolved colour out), its registration by
name, and that a program without the kernel reads nothing."""

import importlib
import sys

import pytest
import torch

from pb import yardstick
from roofline import taa


@pytest.mark.parametrize("h,w", [(1080, 1920), (97, 161), (0, 5)])
def test_taa_bound_counts_40_bytes_a_pixel(h, w):
    n = taa.reduce((torch.zeros(h, w, 3), torch.zeros(h, w), None, None),
                   {}, None)
    assert n == h * w and taa.BYTES_PER_PX == 40
    calls = {(taa.MODULE, "taa_resolve_fused"): [n, n]}
    assert taa.bound_ms(calls) == pytest.approx(
        2 * h * w * 40 / yardstick.HBM_BYTES_PER_S * 1e3)
    if h * w == 1920 * 1080:  # 83 MB: 25 us at 3.35 TB/s
        assert taa.bound_ms(calls) / 2 == pytest.approx(0.02476, rel=1e-3)


def test_reader_registered_on_the_kernel():
    mod = importlib.import_module("metrics.taa_roofline_pct")
    assert mod.KERNEL is taa and mod.WRAPS == []
    prog = importlib.import_module(taa.MODULE)
    assert isinstance(prog.LAUNCHES, int)
    assert callable(prog.taa_resolve_fused)
    assert taa.KERNELS == ("taa_fused_kernel",)

    class Ctx:
        @staticmethod
        def roofline(k):
            assert k is taa
            return 25.0

    assert mod.read(Ctx) == 25.0


def test_reader_reads_nothing_without_the_kernel(monkeypatch):
    """On a program that lacks ops/taa.py the reader has no KERNEL (run.py
    then captures nothing) and reads None."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == taa.MODULE
                        else real(name, *a))
    monkeypatch.delitem(sys.modules, "metrics.taa_roofline_pct",
                        raising=False)
    mod = importlib.import_module("metrics.taa_roofline_pct")
    try:
        assert mod.KERNEL is None

        class Ctx:
            @staticmethod
            def roofline(k):
                raise AssertionError("no roofline without the kernel")

        assert mod.read(Ctx) is None
    finally:
        sys.modules.pop("metrics.taa_roofline_pct", None)
