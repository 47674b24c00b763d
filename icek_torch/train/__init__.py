"""Training: loss, optimizer and the train / eval steps (``step.py``), the
epoch loop (``loop.py``), checkpoints (``checkpoint.py``, with a reader of
JAX's msgpack files in ``msgpack.py``), weight imports (``port.py``) and
GloVe initialization (``embeddings.py``)."""
