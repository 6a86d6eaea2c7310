"""LM training on one device (counterpart of ``repro.train``): AdamW with
f32 master weights (``optimizer``), the train step (``step``), tree
checkpoints on the snapshot store (``checkpoint``) and the elastic
controller (``elastic``)."""
