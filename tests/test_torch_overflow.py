"""Port parity: both raster overflow counters (setup extras / work items
and binned pairs) against the JAX package, at capacities far below the
golden scene so that both fire. The JAX stages run op by op, as in
tests/test_torch_raster.py."""

import dataclasses

import numpy as np
import torch

from tests.test_golden import CFG
from tests.test_torch_raster import T_CFG, _golden_setup

torch.set_num_threads(2)


def test_overflow_counters_match():
    """Both overflow counters fire and agree exactly."""
    jcfg = dataclasses.replace(CFG, tri_capacity=1 << 12,
                               pair_capacity=1 << 10)
    tcfg = dataclasses.replace(T_CFG, tri_capacity=1 << 12,
                               pair_capacity=1 << 10)
    small = _golden_setup(jcfg, tcfg)
    j_setup_ovf = int(small["jsetup"]["setup_overflow"])
    assert j_setup_ovf > 0
    assert j_setup_ovf == int(small["tsetup"]["setup_overflow"])
    j_bin_ovf, t_bin_ovf = int(small["jbin"][3]), int(small["tbin"][3])
    assert j_bin_ovf > 0 and j_bin_ovf == t_bin_ovf
    np.testing.assert_array_equal(np.asarray(small["jbin"][2]),
                                  small["tbin"][2].numpy())
