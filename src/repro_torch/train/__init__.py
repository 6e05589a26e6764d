"""Training: AdamW (``optimizer``), checkpoints (``checkpoint``) and the
train loop (``trainer``), the port of the reference package's
``repro/train``.  Its gradient compression (``compression.py``) is a
collective and comes with the multi-GPU slice."""
