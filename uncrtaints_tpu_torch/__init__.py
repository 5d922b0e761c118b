"""UnCRtainTS in PyTorch for NVIDIA Hopper: the port of ``uncrtaints_tpu``.

The JAX package beside it is the reference every module here is tested
against. The tree mirrors it (``models/``, ``ops/``, ``losses/``,
``metrics/``, ``data/``, ``train/``) with the same module and class names.
The TPU's Pallas kernels become hand-written CUDA kernels (``csrc/``, built
at first use by ``_build``); each has a plain PyTorch version beside it,
which runs for CPU tensors. This package imports neither JAX nor the JAX
package: it keeps its own copies of the config, the synthetic data source
and the collate.

Ported so far: every UnCRtainTS configuration, the eval step, the train
step and whole-scene inference. Library use::

    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

    cfg = derive(Config(use_sar=True, scale_by=10.0))
    model = get_generator(cfg)                      # on cfg.device: "cuda"
    step = make_eval_step(cfg, with_metrics=True)
    aux = step(model, batch_to_device(numpy_batch, "cuda"))
    out = predict_scene(model, cfg, scene, dates)   # [T,H,W,C] -> pred, var
"""
