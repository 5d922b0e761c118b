"""UnCRtainTS in PyTorch for NVIDIA Hopper: the port of ``uncrtaints_tpu``.

The JAX package beside it is the reference every module here is tested
against. The tree mirrors it (``models/``, ``ops/``, ``losses/``,
``metrics/``, ``data/``, ``train/``, ``cli/``) with the same module and class names.
The TPU's Pallas kernels become hand-written CUDA kernels (``csrc/``, built
at first use by ``_build``); each has a plain PyTorch version beside it,
which runs for CPU tensors. This package imports neither JAX nor the JAX
package: it keeps its own copies of the config, the synthetic data source,
the collates and the loader, the host radiometry and the calibration
metrics.

Ported so far: every UnCRtainTS configuration and baseline family, the
eval step, the train step, whole-scene inference, and the entry points
around them: the loader (``data/pipeline.py``, its slab writers compiled in
``native/``), the epoch loop, checkpoints and the observer (``train/``),
the commands ``python -m uncrtaints_tpu_torch.cli.train`` and ``cli.test``
(data parallel over one process a GPU, ``parallel/``), and the serving
export (``export.py``). The kernels are dispatcher operators
(``torch.ops.uncrtaints``). Library use::

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
