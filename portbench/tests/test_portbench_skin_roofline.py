"""The skin pose kernel's roofline reader: its byte count (228 B a posed
triangle: rest vectors, weights and one-byte joint indices in, position
and octahedral words out), its registration by name, and that a program
without the kernel reads nothing."""

import importlib
import sys
import types

import pytest

from pb import yardstick
from roofline import skin


@pytest.mark.parametrize("n_tri", [32 * 11_536, 48, 0])
def test_skin_bound_counts_228_bytes_a_triangle(n_tri):
    batch = types.SimpleNamespace(n_tri=n_tri)
    n = skin.reduce((batch, None, None, None, None, None), {}, None)
    assert n == n_tri and skin.BYTES_PER_TRI == 228
    calls = {(skin.MODULE, "pose_skins"): [n, n]}
    assert skin.bound_ms(calls) == pytest.approx(
        2 * n_tri * 228 / yardstick.HBM_BYTES_PER_S * 1e3)
    if n_tri == 32 * 11_536:  # the crowd: 84 MB, 25 us at 3.35 TB/s
        assert skin.bound_ms(calls) / 2 == pytest.approx(0.02512, rel=1e-3)


def test_reader_registered_on_the_kernel():
    mod = importlib.import_module("metrics.skin_roofline_pct")
    assert mod.KERNEL is skin and mod.WRAPS == []
    prog = importlib.import_module(skin.MODULE)
    assert isinstance(prog.LAUNCHES, int)
    assert callable(prog.pose_skins)
    assert skin.KERNELS == ("skin_pose_kernel",)

    class Ctx:
        @staticmethod
        def roofline(k):
            assert k is skin
            return 40.0

    assert mod.read(Ctx) == 40.0


def test_reader_reads_nothing_without_the_kernel(monkeypatch):
    """On a program that lacks ops/skin.py the reader has no KERNEL (run.py
    then captures nothing) and reads None."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == skin.MODULE
                        else real(name, *a))
    monkeypatch.delitem(sys.modules, "metrics.skin_roofline_pct",
                        raising=False)
    mod = importlib.import_module("metrics.skin_roofline_pct")
    try:
        assert mod.KERNEL is None

        class Ctx:
            @staticmethod
            def roofline(k):
                raise AssertionError("no roofline without the kernel")

        assert mod.read(Ctx) is None
    finally:
        sys.modules.pop("metrics.skin_roofline_pct", None)
