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
with the registry's baselines that run on a uniform-rank fleet
(``core/methods.py``) and Fig. 1's ``core/sensitivity.py``.
Everything else raises ``NotImplementedError`` naming its ROADMAP item.
"""
from repro_torch.device import resolve_device  # noqa: F401
