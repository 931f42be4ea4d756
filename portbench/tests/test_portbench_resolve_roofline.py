"""The dense resolve kernel's roofline reader: its byte count (68 B a
pixel: the visibility image in, the seven output images out) and its
registration by name, and that a program without the kernel reads
nothing."""

import importlib
import sys
import types

import pytest
import torch

from pb import yardstick
from roofline import resolve


@pytest.mark.parametrize("h,w", [(1080, 1920), (184, 320), (0, 5)])
def test_resolve_bound_counts_68_bytes_a_pixel(h, w):
    vis = types.SimpleNamespace(depth=torch.zeros(h, w))
    n = resolve.reduce((None, vis, None), {}, None)
    assert n == h * w
    calls = {(resolve.MODULE, "resolve_dense"): [n, n]}
    assert resolve.bound_ms(calls) == pytest.approx(
        2 * h * w * 68 / yardstick.HBM_BYTES_PER_S * 1e3)
    if h * w == 1920 * 1080:  # 141 MB: 0.042 ms at 3.35 TB/s
        assert resolve.bound_ms(calls) / 2 == pytest.approx(0.04209,
                                                            rel=1e-3)


def test_reader_registered_on_the_kernel():
    mod = importlib.import_module("metrics.resolve_roofline_pct")
    assert mod.KERNEL is resolve and mod.WRAPS == []
    prog = importlib.import_module(resolve.MODULE)
    assert isinstance(prog.LAUNCHES, int)
    assert callable(prog.resolve_dense)
    assert resolve.KERNELS == ("resolve_dense_kernel",)

    class Ctx:
        @staticmethod
        def roofline(k):
            assert k is resolve
            return 12.5

    assert mod.read(Ctx) == 12.5


def test_reader_reads_nothing_without_the_kernel(monkeypatch):
    """On a program that lacks ops/resolve.py the reader has no KERNEL
    (run.py then captures nothing) and reads None."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == resolve.MODULE
                        else real(name, *a))
    monkeypatch.delitem(sys.modules, "metrics.resolve_roofline_pct",
                        raising=False)
    mod = importlib.import_module("metrics.resolve_roofline_pct")
    try:
        assert mod.KERNEL is None

        class Ctx:
            @staticmethod
            def roofline(k):
                raise AssertionError("no roofline without the kernel")

        assert mod.read(Ctx) is None
    finally:
        sys.modules.pop("metrics.resolve_roofline_pct", None)
