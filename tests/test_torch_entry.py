"""The port's ``entry`` step against the JAX package's, on the CPU.

``trust4_tpu_torch.entry.entry(device="cpu")`` must build the JAX
``__graft_entry__.entry()`` inputs from the same numpy seeds and give
its output bit for bit: the membership prefilter mask over 256 reads and
the banded scores of 256 pairs at band 32 (the plain DP on the CPU).
"""

import os
import sys

import numpy as np
import pytest
import torch

from trust4_tpu_torch import entry as port_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    return [np.asarray(a) for a in args], np.asarray(fn(*args))


def test_inputs_match_jax(jax_entry):
    want_args, _ = jax_entry
    _fn, args = port_entry.entry(device="cpu")
    assert len(args) == len(want_args)
    for a, b in zip(args, want_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.numpy().dtype == b.dtype


def test_output_matches_jax(jax_entry):
    _, want = jax_entry
    fn, args = port_entry.entry(device="cpu")
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefilter masks some pairs and passes others
    assert 0 < (want != -(1 << 29)).sum() < len(want)


def test_make_step_takes_the_dp(monkeypatch):
    """The step's DP is ops/dp_scores ``banded_affine_scores``, looked up
    at call time, once per step at band 32."""
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.ops.dp import banded_affine_scores_plain

    fn, args = port_entry.entry(device="cpu")
    want = fn(*args).numpy()
    bands = []

    def plain(*a):
        bands.append(a[-1])
        return banded_affine_scores_plain(*a)

    monkeypatch.setattr(dp_scores, "banded_affine_scores", plain)
    np.testing.assert_array_equal(fn(*args).numpy(), want)
    assert bands == [32]
