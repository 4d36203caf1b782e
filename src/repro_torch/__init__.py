"""PyTorch/CUDA port of the FedLoRA-Optimizer system (``repro``'s twin).

Module paths mirror ``repro``'s (``repro_torch/models/layers.py`` ↔
``repro/models/layers.py``); parameters are nested dicts of tensors keyed
by the same "/"-joined leaf paths, with the stacked ``(n_superblocks, …)``
block layout kept as is.  The package imports ``torch`` and numpy only:
importing it needs neither a card, ``nvcc`` nor ``triton`` — the CUDA
kernels build on first use (``kernels/_build.py``).

Ported so far: the dense decoder and the multi-tenant serving path
(``AdapterStore`` → ``ServeEngine``) through hand-written Hopper BGMV
kernels; fused-DoRA generation (``cfg.use_fused_dora``) through the
``fused_dora`` kernel; the int8/int4 quantized serving backbone
(``cfg.backbone_quant``) through the ``quant_matmul`` kernel; and the
paper's training pipeline (``core/fedlora.run_federated`` →
``fed/simulate.FedSim``, ``optim/``, ``data/``) through torch autograd,
with all 14 methods of the reference's registry (``core/methods.py``),
mixed-rank fleets and Fig. 1's ``core/sensitivity.py``; checkpoints in
the reference's msgpack format and the tiered adapter store; telemetry
(``obs``: metrics, JSONL events, profiler spans, zero cost when
disabled); and cross-device cohorts (``fed.cohort``: a host-side client
bank, cohort sampling, dropouts, stragglers and corrupted updates).
All 11 of the reference's architectures run, as does the production
round engine (``launch/train.py``); so do backbone pretraining
(``fed/pretrain.py``), the tokenizer, the abstract trees and analytic
step account (``launch/specs.py``, ``launch/analysis.py``) and the user
examples (``examples/``), the one-card dry run and its report
(``launch/dryrun.py``, ``launch/report.py``: each step run once on meta
tensors) and the analyzer's dead-mask rule and sanitizer (``lint/``).
"""
from repro_torch import obs  # noqa: F401
from repro_torch.device import resolve_device  # noqa: F401
from repro_torch.fed import cohort  # noqa: F401
