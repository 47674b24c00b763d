"""icek_torch — the PyTorch/CUDA port of icek_tpu for NVIDIA Hopper.

Mirrors ``icek_tpu``'s layout module for module, imports nothing of it and
nothing of JAX.  Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with nvcc
at first use (``kernels/_build.py``) and called through a wrapper that runs
the kernel's plain PyTorch version only for CPU tensors.

Ported so far (the geo, knowledge and news presets: serving, the eval run
and the training run):
    core/      config dataclasses + presets (own copy)
    data/      image normalization, the codec pieces detok needs, the
               split loader and its epoch iterators
    models/    transformer stacks, ResNet-101 encoder, captioner (all
               three variants: entity and fact encoders, pointer head)
    kernels/   flash attention forward and backward, fused residual-dropout-
               LayerNorm and dropout, fused score/top-k, decoder-step
    decode/    top-k, greedy and beam decode, detok
    train/     masked-CE loss, clip + Adam, train and eval steps, the epoch
               loop, checkpoints (reads JAX's msgpack too), weight imports
    serve/     the serving engine, its HTTP server and the replica router
    apps/      ``python -m icek_torch.apps {train,eval,serve}``
    bridge.py  JAX param and optimizer trees (as numpy) <-> the port's tensors
    eval_driver.py  Evaluator: decode_batch and the eval run
"""

__version__ = "0.1.0"
