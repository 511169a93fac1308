"""The plain bodies of the port's microbenchmark
(trust4_tpu_torch/tools/vpu_microbench.py) against closed forms and
numpy, at a reduced K.  On the card each kernel body must equal its plain
body (tests/test_torch_card.py, chip_smoke.py); here the plain bodies are
pinned to what the JAX tool's bodies compute (tools/vpu_microbench.py:
72-132), exactly (int32, tolerance 0)."""

import numpy as np
import pytest
import torch

from trust4_tpu_torch.tools import vpu_microbench as vb

K_SMALL = 40


def _tile(w=8, lanes=16):
    return np.random.default_rng(3).integers(0, 100, (w, lanes),
                                             dtype=np.int32)


def _run(name, x, k=K_SMALL):
    return vb.plain_body(name, torch.from_numpy(x), k).numpy()


def _shift_up(x, s):
    """x shifted up s rows, the fill value below."""
    out = np.full_like(x, vb.FILL)
    if s < len(x):
        out[: len(x) - s] = x[s:]
    return out


@pytest.mark.parametrize("name,closed_form", [
    ("chain_max", lambda x, k: x + k // 2),
    ("inter2", lambda x, k: x + 1 + k // 2),
    ("inter4", lambda x, k: x + 3 + k // 2),
    ("indep_max", lambda x, k: x + k // 2 - 1),
    ("chain_where", lambda x, k: x + k * (x > vb.THRESHOLD)),
])
def test_arithmetic_bodies_closed_forms(name, closed_form):
    x = _tile()
    np.testing.assert_array_equal(_run(name, x), closed_form(x, K_SMALL))


@pytest.mark.parametrize("k", [3, 8, K_SMALL])
def test_shift_bodies_against_numpy(k):
    x = _tile()
    np.testing.assert_array_equal(_run("chain_shift", x, k), _shift_up(x, k))
    # K/2 steps of max(x, shift(x)): each row takes the max of itself and
    # the K/2 rows below it, the fill value entering from below; once K/2
    # reaches the tile, the suffix max.
    want = x.copy()
    for _ in range(k // 2):
        want = np.maximum(want, _shift_up(want, 1))
    np.testing.assert_array_equal(_run("shift_max", x, k), want)
    suffix = np.maximum.accumulate(np.vstack([x, np.full((1, x.shape[1]),
                                                         vb.FILL)])[::-1])
    if k // 2 >= len(x):
        np.testing.assert_array_equal(want, suffix[::-1][:-1])


def test_run_body_on_cpu_is_the_plain_body_and_checks_inputs():
    x = torch.from_numpy(_tile(8, 128))
    launches = vb.LAUNCHES
    np.testing.assert_array_equal(vb.run_body("chain_max", x).numpy(),
                                  x.numpy() + vb.K // 2)
    assert vb.LAUNCHES == launches
    with pytest.raises(ValueError, match="unknown body"):
        vb.run_body("nope", x)
    with pytest.raises(ValueError, match="int32"):
        vb.run_body("chain_max", x.long())
    with pytest.raises(ValueError, match="unsupported device"):
        vb.run_body("chain_max", x.to("meta"))


def test_cases_cover_the_jax_tool():
    """Every body of the JAX tool's main() at its (w, lanes), K=512,
    GRID=256, with the operation counts it divides by."""
    assert (vb.K, vb.GRID) == (512, 256)
    assert {c[0] for c in vb.CASES} == set(vb.BODIES)
    sizes = {(c[0], c[1], c[2]): c[4] for c in vb.CASES}
    for w, lanes in ((8, 128), (32, 128), (32, 512)):
        assert sizes[("chain_max", w, lanes)] == vb.K
        assert sizes[("chain_shift", w, lanes)] == vb.K
    assert sizes[("inter2", 32, 128)] == 2 * vb.K
    assert sizes[("inter4", 32, 128)] == 4 * vb.K
