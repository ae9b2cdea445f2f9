"""Runnable walk-throughs of the port, as ``python -m
repro_torch.examples.<name>``: ``quickstart`` (pretrain a tiny LM,
DMS-retrofit it, serve it compressed) and ``retrofit_train`` (pretrain with
checkpoints and auto-resume, then the two-phase DMS retrofit).  Both run on
the card unless ``--device cpu`` is given."""
