"""The port's teacher-forced forward and loss
(icek_torch/models/captioner.py::captioner_forward,
icek_torch/train/step.py::caption_loss) against the JAX package on the
same numpy inputs and params, on the CPU, small geo model (d=40, 4 heads,
V=60, E=9, T=7; helpers shared with tests/test_torch_train.py).

Tolerances.  Scores atol 2e-5 on float32 logits of order 1.  Loss 1e-5
relative; its gradient atol 1e-6 in float32 and one bf16 ulp in bfloat16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.train import step as tstep
from icek_tpu.models import captioner as jcap
from icek_tpu.train import step as jstep
from test_torch_train import PAD, T, E, V, _batch, _cfgs, _params, _port_scores


@pytest.mark.parametrize("flash", [False, True])
def test_captioner_forward_matches_jax(flash):
    """Deterministic teacher-forced scores, stock and flash branches (the
    JAX flash branch runs the Pallas kernel in interpret mode)."""
    jc, tc = _cfgs(layers=2, flash=flash)
    jp, tp = _params(jc, tc)
    batch = _batch(3)
    want = jcap.captioner_forward(
        jp, jc.model, V, PAD, batch["caption_ids"], batch["caption_mask"],
        batch["image_tokens"], batch["entity_features"])
    with torch.no_grad():
        got = _port_scores(tc, tp, batch)
    assert got.shape == (3, T, V + E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_captioner_forward_score_dtype():
    """score_dtype=bfloat16 equals the rounded float32 scores of a bf16 pass."""
    jc, tc = _cfgs()
    _, tp = _params(jc, tc)
    with torch.no_grad():
        hi = _port_scores(tc, tp, _batch(2), compute_dtype=torch.bfloat16)
        lo = _port_scores(tc, tp, _batch(2), compute_dtype=torch.bfloat16,
                          score_dtype=torch.bfloat16)
    assert lo.dtype == torch.bfloat16 and hi.dtype == torch.float32
    torch.testing.assert_close(lo.float(), hi, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caption_loss_matches_jax(rng, dtype):
    """Masked mean CE with <pad> targets and lengths shorter than T, its
    token count, and d_loss/d_scores (in the scores' dtype)."""
    batch = _batch(5, seed=3)
    scores = rng.standard_normal((5, T, V + E)).astype(np.float32) * 2
    js = jnp.asarray(scores).astype(dtype)
    ts = torch.tensor(scores).to(getattr(torch, dtype)).requires_grad_(True)
    want, wcount = jstep.caption_loss(js, batch["caption_ids"], batch["lengths"], PAD)
    wgrad = jax.grad(lambda s: jstep.caption_loss(
        s, batch["caption_ids"], batch["lengths"], PAD)[0])(js)
    got, count = tstep.caption_loss(ts, torch.as_tensor(batch["caption_ids"]),
                                    torch.as_tensor(batch["lengths"]), PAD)
    got.backward()
    assert int(count) == int(wcount) and 0 < int(count) < 5 * (T - 1)
    assert ts.grad.dtype == ts.dtype
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    atol = 1e-6 if dtype == "float32" else 2e-3     # one bf16 ulp of values < 0.25
    np.testing.assert_allclose(ts.grad.float().numpy(),
                               np.asarray(wgrad.astype(jnp.float32)), atol=atol)
    # no valid token: zero loss, not NaN
    zero, n = tstep.caption_loss(ts.detach(), torch.as_tensor(batch["caption_ids"]),
                                 torch.ones(5, dtype=torch.int64), PAD)
    assert int(n) == 0 and float(zero) == 0.0
