"""Runnable walk-throughs of the port, as ``python -m
repro_torch.examples.<name>``: ``quickstart`` (pretrain a tiny LM,
DMS-retrofit it, serve it compressed), ``retrofit_train`` (pretrain with
checkpoints and auto-resume, then the two-phase DMS retrofit) and
``hyperscale_serve`` (the paper's §5.1 demo: a trained chain-arithmetic
reasoner, :mod:`.reasoner`, served vanilla with one chain against DMS with
four chains of one forked prefill).  Each runs on the card unless
``--device cpu`` is given."""
