"""UnCRtainTS in PyTorch for NVIDIA Hopper: the port of ``uncrtaints_tpu``.

The JAX package beside it is the reference every module here is tested
against. The tree mirrors it (``models/``, ``ops/``, ``losses/``,
``metrics/``, ``data/``, ``train/``) with the same module and class names.
The TPU's Pallas kernels become hand-written CUDA kernels (``csrc/``, built
at first use by ``_build``); each has a plain PyTorch version beside it,
which runs for CPU tensors. This package never imports JAX.

Ported so far: the serving path (the no-grad eval step of the paper
recipe). Library use::

    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

    cfg = derive(Config(use_sar=True, scale_by=10.0))
    model = get_generator(cfg, device="cuda")
    step = make_eval_step(cfg, with_metrics=True)
    aux = step(model, batch_to_device(numpy_batch, "cuda"))
"""
