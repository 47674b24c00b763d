"""The premise of the port's dropout under a mesh (train/step.py keys every
mask by global batch row): JAX's sharded masks equal its single-device
ones.  A file of its own because its two JAX compiles take ~35 s."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from icek_tpu.parallel import mesh as jmesh
from icek_tpu.train import step as jstep

V, PAD, LR, RATE = 64, 0, 1e-3, 0.3


def test_jax_sharded_dropout_masks_equal_single_device():
    """JAX's train step on a (4, 2) mesh of the 8 virtual devices at dropout
    0.3 gives its single-device loss to 1e-6 (partitionable threefry draws
    the same bits however the batch is sharded); another key gives another
    loss."""
    import test_parallel

    jc, _, tree, batch = test_parallel._setup(V=V)
    jc = jc.replace(model=dataclasses.replace(
        jc.model, dropout_dec=RATE, dropout_enc=RATE, dropout_pos=RATE))
    tree = jax.tree.map(np.asarray, tree)
    opt = jstep.make_optimizer(LR)
    train, _ = jstep.make_train_step(jc, V, PAD, opt, encode_images=False)

    def loss(mesh_shape, key):
        params, b = jax.tree.map(jnp.asarray, tree), batch
        if mesh_shape:
            m = jmesh.make_mesh(*mesh_shape)
            params, b = jmesh.shard_params(params, m), jmesh.shard_batch(batch, m)
        return float(train(params, opt.init(params), None, b, jax.random.PRNGKey(key))[2])

    single = loss(None, 1)
    np.testing.assert_allclose(loss((4, 2), 1), single, rtol=1e-6)
    assert abs(loss(None, 2) - single) > 1e-4
