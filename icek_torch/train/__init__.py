"""Training: loss, optimizer and the train / eval steps (``step.py``)."""
