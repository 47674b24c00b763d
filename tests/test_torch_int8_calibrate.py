"""``observe`` / ``calibrate`` of the port's int8 encoder
(``icek_torch/models/resnet_int8.py``) against ``icek_tpu.models.resnet_int8``
at the shapes of tests/test_resnet_int8.py (64x64 images, emb 24), in both
modes, and the per-image maxima.

Held to 1e-5 relative.  The observations run 101 float32 convolution
layers, which the two packages sum in another order: on one folded tree the
largest difference is 1.7e-6 relative, so 1e-6 does not hold.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from icek_torch.models import resnet_int8 as tq
from icek_tpu.models import resnet_int8 as jq
from test_torch_common import int8_nets, one_torch_thread  # noqa: F401
from test_torch_common import tree_leaves_with_paths as _leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def nets():
    return int8_nets(24)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
            (rng.standard_normal((2, 64, 64, 3)) * 2).astype(np.float32)]


@pytest.mark.parametrize("mode", ["max", "percentile"])
def test_calibrate_matches_jax(nets, images, mode):
    want = jq.calibrate(nets["jfolded"], [jnp.asarray(b) for b in images],
                        compute_dtype=jnp.float32, mode=mode, percentile=75.0)
    got = tq.calibrate(nets["tfolded"], [torch.from_numpy(b) for b in images],
                       compute_dtype=torch.float32, mode=mode, percentile=75.0)
    w, g = list(_leaves(jax.device_get(want))), list(_leaves(got))
    assert [p for p, _ in w] == [p for p, _ in g] and len(w) == 101
    for (path, a), (_, b) in zip(w, g):
        assert b.shape == ()
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=str(path))


def test_observe_per_image_matches_jax(nets, images):
    want = jax.jit(jq.observe, static_argnums=(2, 3))(
        nets["jfolded"], jnp.asarray(images[0]), jnp.float32, True)
    got = tq.observe(nets["tfolded"], torch.from_numpy(images[0]), torch.float32,
                     per_image=True)
    for (path, a), (_, b) in zip(_leaves(jax.device_get(want)), _leaves(got)):
        assert b.shape == (2,)
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=str(path))


def test_calibrate_needs_a_batch_and_a_known_mode(nets):
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(nets["tfolded"], [], compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="mode"):
        tq.calibrate(nets["tfolded"], [], mode="mean")
