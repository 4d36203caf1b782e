"""The port's user examples, run as modules (``python -m
repro_torch.examples.<name>``, with ``src`` on ``PYTHONPATH``):
``fed_finetune_e2e`` (pretrain → federate → personalize → eval) and
``serve_personalized`` (multi-tenant serving of one mixed batch).
Each runs on the card unless given ``--device cpu``."""
