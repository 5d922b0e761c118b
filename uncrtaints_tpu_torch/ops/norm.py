"""Norm2d on the card, kernel family K6: batch, group and instance norm over
NHWC maps with the affine and the following GELU or ReLU in one pass, and
the backward of the whole.

The JAX package has no Pallas kernel here: its norms
(uncrtaints_tpu/models/layers.py:Norm2d, _moments_f32) are plain XLA ops
that XLA fuses on the TPU (the cast into the reductions, the affine and the
activation into one pass). The CUDA kernels of csrc/norm.cu do that fusion
by hand:

    forward   sums of x and x^2 per (frame, group) -> [collective] ->
              coef / off per (frame, channel) -> y = act(x * coef + off)
    backward  sums of g' and g' * x per (frame, channel), g' = g * act'(pre)
              with the pre-activation recomputed -> A, B, dweight, dbias ->
              [collective over A, B] -> dx = g' * coef + A * x + B

(group and instance norms with no collective, whose frame's slab of whole
groups fits the card's shared memory, take one pass instead: x, and g with
it, cross device memory once; :func:`onchip_plan` decides) as
``torch.library`` operators: ``uncrtaints::norm_act`` (statistics of x:
train-mode batch norm, group and instance norm) with its backward
``uncrtaints::norm_act_bwd``, and ``uncrtaints::norm_affine_act`` (a given
per-channel affine: the eval-mode batch norm) with
``uncrtaints::norm_affine_act_bwd``. Under a mesh the collective runs inside
the operator, between the reduction and the elementwise pass, in both
directions (as torch's SyncBatchNorm): the batch norms' sums over every rank
(a process group is up), the group and instance norms' over the spatial
group (a spatial split is on). The eval group-norm MBConv's kernel chain
takes a norm's passes apart through three more operators (eval only):
``uncrtaints::norm_stats``, ``uncrtaints::norm_apply`` and
``uncrtaints::norm_gelu_pool`` (its squeeze-and-excitation sum).

The wrappers :func:`norm_act` and :func:`affine_act` take a CPU tensor
through the plain version, which is the eager formula the port ran before
(:func:`norm_act_plain`, :func:`affine_act_plain`: fp32 moments as
E[x^2] - E[x]^2 clamped at 0, the affine in the activation dtype, then the
activation), differentiated by autograd; a CUDA tensor through the
operators (the kernels, or a raise). The operators' CPU implementations are
the kernels' plain twins (``*_twin`` below), which the tests and
``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch import _build, tracing
from uncrtaints_tpu_torch.parallel import mesh

# batch_f32: the batch norm of the L-TAE's form that UNet3D runs (flax's
# BatchNorm: the affine ((x - m) * r) * w + b in fp32, rounded once)
KINDS = {"batch": 0, "group": 1, "instance": 2, "batch_f32": 3}
ACTS = {"none": 0, "gelu": 1, "relu": 2, "leaky_relu": 3}  # leaky_relu: slope 0.01
LEAKY_SLOPE = 0.01
# the apply's form of each kind: 0 x * coef + off, 1 (x - off) * coef, each
# in x's dtype; 2 ((x - off) * coef) * w + b in fp32 (coef = r, off = m)
FORMS = {0: 0, 1: 0, 2: 1, 3: 2}
EPS = 1e-5
REDUCE_NONE, REDUCE_WORLD, REDUCE_SPATIAL = 0, 1, 2
_BLOCKS_PER_SM = 4  # the statistics' grid: about this many blocks an SM
_MIN_ROWS = 64  # and at least this many rows a block
_ONCHIP_THREADS = 512  # the one-pass kernels' block (csrc/norm.cu: OC_THREADS)
# Where one pass beats two on an H100 (PERF.md §6, K6): each wave costs a
# few microseconds between its sums and its apply (the block reductions, the
# grid barrier, the per-slot math), so the forward wants waves of at least
# this much x (or a single wave), and the backward, whose waves hold one slab
# of x and fp32 g' at the paths' widths, at most this many waves
_ONCHIP_MIN_WAVE_BYTES = 12 * 2 ** 20
_ONCHIP_MAX_BWD_WAVES = 6


# -------------------------------------------------- the eager formula --

def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """``act`` of y: none, exact (erf) GELU, or ReLU."""
    if act == "gelu":
        return F.gelu(y)
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, LEAKY_SLOPE)
    if act != "none":
        raise ValueError(f"unknown activation {act!r} (none, gelu, relu, leaky_relu)")
    return y


def moments_f32(x: torch.Tensor, dims, keepdim: bool = True):
    """fp32 mean and variance as E[x^2] - E[x]^2 (clamped at 0), the JAX
    package's formula."""
    m = x.mean(dim=dims, keepdim=keepdim, dtype=torch.float32)
    m2 = x.float().square().mean(dim=dims, keepdim=keepdim)
    return m, torch.clamp(m2 - m.square(), min=0.0)


def moments_band_f32(x: torch.Tensor, dims, keepdim: bool, sp):
    """:func:`moments_f32` of the scene when x is one band of it: the fp32
    sums and sums of squares over ``dims`` summed over the spatial group by
    a differentiable all-reduce (the gradient reaches every band's rows),
    divided by the scene's count."""
    xf = x.float()
    tot = mesh.spatial_sum(torch.stack([xf.sum(dim=dims, keepdim=keepdim),
                                        xf.square().sum(dim=dims, keepdim=keepdim)]), sp)
    n = sp.n_spatial
    for d in dims:
        n *= x.shape[d]
    m = tot[0] / n
    return m, torch.clamp(tot[1] / n - m.square(), min=0.0)


def batch_moments_f32(x: torch.Tensor, dims):
    """Train-mode batch-norm statistics: per-channel fp32 mean and biased
    variance (E[x^2] - E[x]^2, clamped at 0) over ``dims``, and the number
    of rows behind them. When a process group is initialised they are the
    global batch's, as under the JAX package's pjit: the per-rank sums, sums
    of squares and counts are summed over the ranks by a differentiable
    all-reduce (parallel/mesh.py), so every rank normalises alike, its
    running statistics stay equal to the others', and the gradient reaches
    every rank's rows."""
    if not mesh.active():
        m, v = moments_f32(x, dims, keepdim=False)
        return m, v, x.numel() // x.shape[-1]
    xf, C = x.float(), x.shape[-1]
    local = torch.cat([xf.sum(dim=dims), xf.square().sum(dim=dims),
                       xf.new_full((1,), x.numel() // C)])
    tot = mesh.all_reduce_sum_grad(local)
    n = tot[-1]
    m = tot[:C] / n
    return m, torch.clamp(tot[C:2 * C] / n - m.square(), min=0.0), n


def unbiased_factor(n):
    """n / (n - 1) for the running variance (1 for a single row); n is the
    row count :func:`batch_moments_f32` returns, an int or a tensor."""
    if isinstance(n, torch.Tensor):
        return n / torch.clamp(n - 1, min=1)
    return n / max(n - 1, 1)


def norm_act_plain(x: torch.Tensor, kind: str, weight: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, groups: int = 4, act: str = "none"):
    """The plain version of :func:`norm_act`: the port's eager Norm2d
    formula (fp32 statistics, the affine in x's dtype) and then ``act``.
    Returns (y, mean, var, count): batch norm the per-channel mean and
    clamped variance [C] and the rows behind them (an int, or a tensor under
    a process group); group and instance norm their statistics with count
    None. Differentiable by autograd; under a mesh its collectives are the
    differentiable ones of parallel/mesh.py."""
    if kind == "batch":
        m, v, n = batch_moments_f32(x, tuple(range(x.dim() - 1)))
        r = torch.rsqrt(v + EPS)
        coef = (r * weight).to(x.dtype)
        offs = (bias - m * r * weight).to(x.dtype)
        return activation(x * coef + offs, act), m, v, n
    if kind == "batch_f32":  # the L-TAE's BatchNorm1d over the rows of [-1, C]
        x2 = x.reshape(-1, x.shape[-1])
        m, v, n = batch_moments_f32(x2, (0,))
        y = (x2.float() - m) * torch.rsqrt(v + EPS) * weight.float() + bias.float()
        return activation(y.to(x.dtype).reshape(x.shape), act), m, v, n
    sp = mesh.spatial()
    moments = (moments_f32 if sp is None else
               lambda t, dims, keepdim=True: moments_band_f32(t, dims, keepdim, sp))
    if kind == "instance":
        m, v = moments(x, (-3, -2))
        y = (x - m.to(x.dtype)) * torch.rsqrt(v + EPS).to(x.dtype)
        return activation(y, act), m, v, None
    if kind != "group":
        raise ValueError(f"unknown norm {kind!r}")
    N, C, g = x.shape[0], x.shape[-1], groups
    m, v = moments(x.reshape(N, -1, g, C // g), (1, 3), keepdim=False)
    mc = m.repeat_interleave(C // g, -1)
    cc = torch.rsqrt(v + EPS).repeat_interleave(C // g, -1) * weight.float()
    off = bias.float() - mc * cc
    shape = (N,) + (1,) * (x.dim() - 2) + (C,)
    y = x * cc.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)
    return activation(y, act), m, v, None


def affine_act_plain(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
                     act: str = "none", weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`affine_act`: act(x * coef + off), the
    product and the sum in x's dtype (the eval batch norm's apply); with a
    weight and a bias act(((x - off) * coef) * weight + bias) in fp32,
    rounded once (the eval form of the L-TAE's BatchNorm1d: coef = r, off =
    the running mean)."""
    if weight is None:
        return activation(x * coef + off, act)
    y = (x.float() - off) * coef * weight.float() + bias.float()
    return activation(y.to(x.dtype), act)


# ------------------------------------------- the kernels' plain twins --
#
# The same functions as the kernels, in torch ops, at the kernels'
# interfaces: x as [F, P, C] (F frames of P rows; the batch norm one frame),
# the per-slot coef / off [F, C] in x's dtype. The operators' CPU
# implementations; chip_smoke.py holds the kernels against them on the card.

def _pre(x3: torch.Tensor, coef: torch.Tensor, off: torch.Tensor, form: int, w=None,
         b=None) -> torch.Tensor:
    """The rounded pre-activation: form 0 x * coef + off, form 1 (x - off)
    * coef, each operation in x's dtype; form 2 ((x - off) * coef) * w + b
    in fp32, rounded once."""
    c, o = coef[:, None, :], off[:, None, :]
    if form == 2:
        return (((x3.float() - o) * c) * w.float() + b.float()).to(x3.dtype)
    return x3 * c + o if form == 0 else (x3 - o) * c


def _act_grad(pre: torch.Tensor, act: int) -> torch.Tensor:
    """d act / d pre in fp32 (torch's GeluBackward, threshold_backward)."""
    p = pre.float()
    if act == ACTS["gelu"]:
        cdf = 0.5 * (1.0 + torch.erf(p * 0.7071067811865476))
        return cdf + p * (torch.exp(-0.5 * p * p) * 0.3989422804014327)
    if act == ACTS["relu"]:
        return (p > 0).float()
    if act == ACTS["leaky_relu"]:
        return torch.where(p > 0, 1.0, LEAKY_SLOPE)
    return torch.ones_like(p)


_ACT_NAMES = {v: k for k, v in ACTS.items()}


def stats_twin(x3: torch.Tensor, groups: int) -> torch.Tensor:
    """[2, F, G] fp32: the sums of x and of x^2 per frame and group."""
    Fr, P, C = x3.shape
    xg = x3.float().view(Fr, P, groups, C // groups)
    return torch.stack([xg.sum(dim=(1, 3)), xg.square().sum(dim=(1, 3))])


def finalize_twin(sums: torch.Tensor, count, weight: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], kind: int, C: int, dtype: torch.dtype):
    """(coef, off [F, C] in ``dtype``, mvn [3 F G + 1]: mean, clamped
    variance, variance before the clamp, n) from sums [2, F, G] and the
    count n (a number or a one-element tensor)."""
    s, q = sums[0], sums[1]
    Fr, G = s.shape
    n = count if isinstance(count, torch.Tensor) else torch.tensor(float(count))
    n = n.reshape(()).to(s.device, torch.float32)
    m = s / n
    raw = q / n - m * m
    v = torch.clamp(raw, min=0.0)
    r = torch.rsqrt(v + EPS)
    mc, rc = (t.repeat_interleave(C // G, -1) for t in (m, r))
    if kind in (KINDS["instance"], KINDS["batch_f32"]):
        cf, of = rc, mc
    elif kind == KINDS["batch"]:
        cf = rc * weight.float()
        of = bias.float() - mc * rc * weight.float()
    else:
        cf = rc * weight.float()
        of = bias.float() - mc * cf
    mvn = torch.cat([m.reshape(-1), v.reshape(-1), raw.reshape(-1), n.reshape(1)])
    return cf.to(dtype), of.to(dtype), mvn


def apply_twin(x3: torch.Tensor, coef: torch.Tensor, off: torch.Tensor, form: int,
               act: int, w=None, b=None) -> torch.Tensor:
    """y = act(pre), pre as :func:`_pre`, the activation in fp32 rounded once
    (torch's activations of x's dtype)."""
    return activation(_pre(x3, coef, off, form, w, b), _ACT_NAMES[act])


def bwd_stats_twin(g3: torch.Tensor, x3: torch.Tensor, coef: torch.Tensor,
                   off: torch.Tensor, form: int, act: int, w=None, b=None) -> torch.Tensor:
    """[2, F, C] fp32: the sums over each frame's rows of g' = g * act'(pre)
    and of g' * x."""
    gp = g3.float() * _act_grad(_pre(x3, coef, off, form, w, b), act)
    return torch.stack([gp.sum(dim=1), (gp * x3.float()).sum(dim=1)])


def bwd_finalize_twin(S: torch.Tensor, mvn: torch.Tensor, weight: Optional[torch.Tensor],
                      coef: torch.Tensor, off: torch.Tensor, kind: int, groups: int):
    """(ab [2, F, C]: A and B of dx = g' * coef + A * x + B a slot; dweight,
    dbias [C] fp32, None for instance norm) from the slots' sums S [2, F, C]
    and the forward's mvn: the chain through the affine, rsqrt, the clamp
    (its gradient passes where the variance before it is >= 0) and the
    moments."""
    s1, s2 = S[0], S[1]
    Fr, C = s1.shape
    G, FG = groups, Fr * groups
    m, v, raw, n = mvn[:FG].view(Fr, G), mvn[FG:2 * FG].view(Fr, G), mvn[2 * FG:3 * FG].view(
        Fr, G), mvn[3 * FG]
    r = torch.rsqrt(v + EPS)
    rep = lambda t: t.repeat_interleave(C // G, -1)
    grp = lambda t: t.view(Fr, G, C // G).sum(-1)
    if kind == KINDS["instance"]:
        mt, rt = off.float(), coef.float()
        dr, dm = grp(s2 - mt * s1), grp(-rt * s1)
    else:
        w = weight.float()
        dr, dm = grp(w * (s2 - rep(m) * s1)), grp(-rep(r) * w * s1)
    dv = torch.where(raw >= 0, dr * -0.5 * r * r * r, torch.zeros_like(dr))
    A, B = 2.0 * dv / n, (dm - 2.0 * m * dv) / n
    ab = torch.stack([rep(A), rep(B)])
    if kind == KINDS["instance"]:
        return ab, None, None
    return ab, (rep(r) * (s2 - rep(m) * s1)).sum(0), s1.sum(0)


def dx_twin(g3: torch.Tensor, x3: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
            ab: Optional[torch.Tensor], form: int, act: int, w=None, b=None) -> torch.Tensor:
    """dx = g' * coef + A * x + B in fp32 (ab None: g' * coef; form 2 g' * r
    * w), rounded once to x's dtype."""
    gp = g3.float() * _act_grad(_pre(x3, coef, off, form, w, b), act)
    mult = coef.float() * w.float() if form == 2 else coef.float()
    d = gp * mult[:, None, :]
    if ab is not None:
        d = d + ab[0][:, None, :] * x3.float() + ab[1][:, None, :]
    return d.to(x3.dtype)


# ------------------------------------------------- the one-pass rule --

class OnchipPlan(NamedTuple):
    """The one-pass kernels' waves: slabs of ``W`` channels (whole groups)
    of one frame's rows, ``K`` slabs a wave, each over ``bps`` blocks (one an
    SM) of ``rpb`` rows."""
    W: int
    K: int
    bps: int
    rpb: int


def _onchip_row_bytes(W: int, itemsize: int, backward: bool) -> int:
    """The bytes a one-pass block holds of a row of its slab: x (backward:
    x and, beside it, g' in fp32)."""
    return W * (itemsize + 4 * backward)


def _onchip_smem_bytes(rpb: int, W: int, itemsize: int, backward: bool) -> int:
    """A one-pass block's shared memory (csrc/norm.cu: onchip_smem_bytes):
    its ``rpb`` rows and the fp32 scratch of its sums."""
    data = -(-rpb * _onchip_row_bytes(W, itemsize, backward) // 16) * 16
    return data + 4 * (_ONCHIP_THREADS * 8 + _ONCHIP_THREADS + 2 * W)


def onchip_plan(kind: str, frames: int, rows: int, channels: int, groups: int, itemsize: int,
                reduce: int, sms: int, smem: int, backward: bool = False) -> Optional[OnchipPlan]:
    """Whether a norm call takes the one-pass kernels, and their waves; None
    sends it to the two passes. ``kind`` a name of :data:`KINDS` or
    ``"affine"`` (``norm_affine_act``); ``frames`` x ``rows`` rows of
    ``channels`` channels (``_geometry``), ``itemsize`` x's bytes an
    element, ``reduce`` the operator's collective; the card's ``sms`` and
    the shared memory a block may opt into (``smem``).

    One pass needs statistics per frame (group, instance) and no collective
    between the passes, rows of whole 16-byte vectors, and a slab of whole
    groups of one frame whose rows (backward: x and g' in fp32) fit the
    shared memory of at most ``sms`` blocks. Of the group counts a slab may
    take (row pieces of at least 128 bytes, or the whole row), the one that
    holds the most bytes a wave wins, the wider on a tie; its slabs take as
    many blocks as the card has to spare. Then one pass must be the faster:
    a forward of one wave or of waves of at least 12 MiB of x, a backward of
    at most 6 waves (measured crossovers; below them the fixed cost of a
    wave outweighs the pass it saves)."""
    if kind not in ("group", "instance") or reduce != REDUCE_NONE or itemsize not in (2, 4):
        return None
    C, P = channels, rows
    G = C if kind == "instance" else groups
    if frames < 1 or P < 1 or C % G or (C * itemsize) % 16:
        return None
    cg = C // G
    best, key = None, None
    for gr in (d for d in range(1, G + 1) if G % d == 0):
        W = gr * cg
        piece = W * itemsize
        if piece % 16 or W > _ONCHIP_THREADS or piece < min(128, C * itemsize):
            continue
        cap = ((smem - _onchip_smem_bytes(0, W, itemsize, backward))
               // _onchip_row_bytes(W, itemsize, backward))
        if cap < 1 or -(-P // cap) > sms:
            continue
        K = min(sms // -(-P // cap), frames * (C // W))
        bps = min(sms // K, P)
        plan = OnchipPlan(W, K, bps, -(-P // bps))
        if key is None or (K * P * piece, W) > key:
            best, key = plan, (K * P * piece, W)
    if best is None:
        return None
    waves = -(-frames * (C // best.W) // best.K)
    if backward:
        return best if waves <= _ONCHIP_MAX_BWD_WAVES else None
    return best if waves == 1 or key[0] >= _ONCHIP_MIN_WAVE_BYTES else None


# ------------------------------------------------------ the launches --

@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bpf(x: torch.Tensor, Fr: int, P: int, per_sm: int = _BLOCKS_PER_SM) -> int:
    """Blocks a frame of the sums' first pass: about ``per_sm`` blocks an SM
    in all, at least _MIN_ROWS rows a block."""
    want = -(-per_sm * _sm_count(x.device.index or 0) // Fr)
    return max(1, min(want, -(-P // _MIN_ROWS)))


_VP, _CI, _CLL, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the C entry points of csrc/norm.cu and their argument types
_ENTRIES = {
    "uncr_norm_stats": [_VP, _CI, _CLL, _CLL, _CI, _CI, _CI, _VP, _VP, _VP],
    "uncr_norm_finalize": [_VP, _VP, _CF, _VP, _VP, _CI, _CI, _CLL, _CI, _CI, _CI, _VP, _VP, _VP,
                           _VP],
    "uncr_norm_apply": [_VP, _VP, _VP, _VP, _VP, _CI, _VP, _CI, _CLL, _CLL, _CI, _CI, _CI, _VP],
    "uncr_norm_bwd_stats": [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CLL, _CLL, _CI, _CI, _CI,
                            _CI, _VP, _VP, _VP],
    "uncr_norm_bwd_finalize": [_VP, _VP, _VP, _CI, _VP, _VP, _CI, _CLL, _CI, _CI, _CI, _VP, _VP,
                               _VP, _VP],
    "uncr_norm_dx": [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _VP, _VP, _CI, _CLL, _CLL, _CI, _CI, _CI,
                     _VP],
    "uncr_norm_forward": [_VP, _VP, _VP, _CI, _CI, _CI, _CLL, _CLL, _CI, _CI, _CI, _CI, _CI, _CF,
                          _VP, _VP, _VP, _VP, _VP, _VP],
    "uncr_norm_backward": [_VP, _VP, _VP, _VP, _CI, _VP, _VP, _VP, _CI, _CI, _CLL, _CLL, _CI,
                           _CI, _CI, _CI, _CI, _VP, _VP, _VP, _VP, _VP],
    "uncr_norm_forward_onchip": [_VP, _VP, _VP, _CI, _CI, _CI, _CLL, _CLL, _CI, _CI, _CI, _CI,
                                 _CI, _CLL, _CI, _CF, _VP, _VP, _VP, _VP, _VP, _VP],
    "uncr_norm_backward_onchip": [_VP, _VP, _VP, _CI, _VP, _VP, _VP, _CI, _CI, _CLL, _CLL, _CI,
                                  _CI, _CI, _CI, _CI, _CLL, _CI, _VP, _VP, _VP, _VP, _VP, _VP],
    "uncr_norm_gelu_pool": [_VP, _CI, _CLL, _CLL, _CI, _CI, _VP, _VP, _VP, _VP, _CI, _VP, _VP,
                            _VP],
    "uncr_device_limits": [_VP],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """The C entry point ``name``, its argument types declared once."""
    return _build.kernel(name, _ENTRIES[name])


def _call(name: str, dev: torch.device, *args) -> None:
    """Launch ``name`` on the current stream of ``dev``; raise on a CUDA
    error."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        err = _fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _code(t: Optional[torch.Tensor]) -> int:
    return _build.DTYPE_CODES[t.dtype] if t is not None else 0


def stats_kernel(x3: torch.Tensor, groups: int, extra: int = 0) -> torch.Tensor:
    """[2 F G + extra] fp32: the sums of x and of x^2 per (frame, group) by
    the kernel, then ``extra`` slots the caller fills (a count to reduce)."""
    Fr, P, C = x3.shape
    bpf = _bpf(x3, Fr, P)
    part = torch.empty(2 * Fr * bpf * C, dtype=torch.float32, device=x3.device)
    out = torch.empty(2 * Fr * groups + extra, dtype=torch.float32, device=x3.device)
    _call("uncr_norm_stats", x3.device, x3.data_ptr(), _code(x3), Fr, P, C, groups, bpf,
          part.data_ptr(), out.data_ptr())
    return out


def finalize_kernel(sums: torch.Tensor, count, weight, bias, kind: int, Fr: int, G: int,
                    C: int, dtype: torch.dtype):
    """The kernel of :func:`finalize_twin`; ``count`` a number or a
    one-element fp32 tensor on the card (read there)."""
    dev = sums.device
    coef = torch.empty((Fr, C), dtype=dtype, device=dev)
    off = torch.empty_like(coef)
    mvn = torch.empty(3 * Fr * G + 1, dtype=torch.float32, device=dev)
    cdev = count if isinstance(count, torch.Tensor) else None
    _call("uncr_norm_finalize", dev, sums.data_ptr(), _ptr(cdev),
          0.0 if cdev is not None else float(count), _ptr(weight), _ptr(bias), _code(weight),
          kind, Fr, G, C, _build.DTYPE_CODES[dtype], coef.data_ptr(), off.data_ptr(),
          mvn.data_ptr())
    return coef, off, mvn


def apply_kernel(x3: torch.Tensor, coef: torch.Tensor, off: torch.Tensor, form: int,
                 act: int, w=None, b=None) -> torch.Tensor:
    Fr, P, C = x3.shape
    y = torch.empty_like(x3)
    _call("uncr_norm_apply", x3.device, x3.data_ptr(), coef.data_ptr(), off.data_ptr(), _ptr(w),
          _ptr(b), _code(w), y.data_ptr(), _code(x3), Fr, P, C, form, act)
    return y


def bwd_stats_kernel(g3: torch.Tensor, x3: torch.Tensor, coef: torch.Tensor,
                     off: torch.Tensor, form: int, act: int, w=None, b=None) -> torch.Tensor:
    Fr, P, C = x3.shape
    bpf = _bpf(x3, Fr, P)
    part = torch.empty(2 * Fr * bpf * C, dtype=torch.float32, device=x3.device)
    S = torch.empty((2, Fr, C), dtype=torch.float32, device=x3.device)
    _call("uncr_norm_bwd_stats", x3.device, g3.data_ptr(), x3.data_ptr(), coef.data_ptr(),
          off.data_ptr(), _ptr(w), _ptr(b), _code(w), _code(x3), Fr, P, C, form, act, bpf,
          part.data_ptr(), S.data_ptr())
    return S


def _param_grads(weight, kind: int, C: int, dev):
    """dweight, dbias [C] in the weight's dtype (None for instance norm)."""
    if kind == KINDS["instance"]:
        return None, None
    return (torch.empty(C, dtype=weight.dtype, device=dev) for _ in range(2))


def bwd_finalize_kernel(S: torch.Tensor, mvn: torch.Tensor, weight, coef: torch.Tensor,
                        off: torch.Tensor, kind: int, groups: int):
    _, Fr, C = S.shape
    ab = torch.empty((2, Fr, C), dtype=torch.float32, device=S.device)
    dw, db = _param_grads(weight, kind, C, S.device)
    _call("uncr_norm_bwd_finalize", S.device, S.data_ptr(), mvn.data_ptr(), _ptr(weight),
          _code(weight), coef.data_ptr(), off.data_ptr(), kind, Fr, groups, C, _code(coef),
          ab.data_ptr(), _ptr(dw), _ptr(db))
    return ab, dw, db


def dx_kernel(g3: torch.Tensor, x3: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
              ab: Optional[torch.Tensor], form: int, act: int, w=None, b=None) -> torch.Tensor:
    Fr, P, C = x3.shape
    dx = torch.empty_like(x3)
    _call("uncr_norm_dx", x3.device, g3.data_ptr(), x3.data_ptr(), coef.data_ptr(),
          off.data_ptr(), _ptr(w), _ptr(b), _code(w), _ptr(ab), dx.data_ptr(), _code(x3), Fr, P,
          C, form, act)
    return dx


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt into) of card ``index``."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        _build.check(_fn("uncr_device_limits")(ctypes.addressof(out)), "uncr_device_limits")
    return tuple(out)


_KIND_NAMES = {v: k for k, v in KINDS.items()}


def _onchip_route(x3: torch.Tensor, kind: int, G: int, backward: bool,
                  *tensors: torch.Tensor) -> Optional[OnchipPlan]:
    """:func:`onchip_plan` for this call on its card (no collective: the
    whole pass in one process), None also where a tensor the kernel reads
    or writes in 16-byte vectors is not aligned to them."""
    if any(t.data_ptr() % 16 for t in (x3, *tensors)):
        return None
    Fr, P, C = x3.shape
    index = x3.device.index if x3.device.index is not None else torch.cuda.current_device()
    return onchip_plan(_KIND_NAMES[kind], Fr, P, C, G, x3.element_size(), REDUCE_NONE,
                       *_device_limits(index), backward=backward)


def forward_kernel(x3: torch.Tensor, weight, bias, kind: int, G: int, act: int, form: int,
                   count: int):
    """The whole forward (no collective between the passes): in one pass
    where :func:`onchip_plan` admits the call (counted in
    ``norm_act.onchip``, and its x's bytes in the step's ``norm_onchip``
    counter), else the two passes. (y, coef, off, mvn)."""
    plan = _onchip_route(x3, kind, G, False)
    if plan is None:
        return forward_two_pass(x3, weight, bias, kind, G, act, form, count)
    out = forward_one_pass(x3, weight, bias, kind, G, act, count, plan)
    norm_act.onchip += 1
    if tracing.recording():
        tracing.count("norm_onchip", tracing.nbytes(x3))
    return out


def forward_one_pass(x3: torch.Tensor, weight, bias, kind: int, G: int, act: int, count: int,
                     plan: OnchipPlan):
    """The one-pass forward kernel under ``plan``: (y, coef, off, mvn)."""
    Fr, P, C = x3.shape
    dev = x3.device
    part = torch.empty(4 * plan.K * plan.bps * (plan.W // (C // G)), dtype=torch.float32,
                       device=dev)
    coef = torch.empty((Fr, C), dtype=x3.dtype, device=dev)
    off = torch.empty_like(coef)
    mvn = torch.empty(3 * Fr * G + 1, dtype=torch.float32, device=dev)
    y = torch.empty_like(x3)
    _call("uncr_norm_forward_onchip", dev, x3.data_ptr(), _ptr(weight), _ptr(bias), _code(weight),
          kind, _code(x3), Fr, P, C, G, plan.W, plan.K, plan.bps, plan.rpb, act, float(count),
          part.data_ptr(), coef.data_ptr(), off.data_ptr(), mvn.data_ptr(), y.data_ptr())
    return y, coef, off, mvn


def forward_two_pass(x3: torch.Tensor, weight, bias, kind: int, G: int, act: int, form: int,
                     count: int):
    """The whole forward in one C call of the two-pass kernels:
    (y, coef, off, mvn)."""
    Fr, P, C = x3.shape
    dev = x3.device
    bpf = _bpf(x3, Fr, P)
    scratch = torch.empty(2 * Fr * bpf * C + 2 * Fr * G, dtype=torch.float32, device=dev)
    coef = torch.empty((Fr, C), dtype=_slot_dtype(x3, kind), device=dev)
    off = torch.empty_like(coef)
    mvn = torch.empty(3 * Fr * G + 1, dtype=torch.float32, device=dev)
    y = torch.empty_like(x3)
    _call("uncr_norm_forward", dev, x3.data_ptr(), _ptr(weight), _ptr(bias), _code(weight), kind,
          _code(x3), Fr, P, C, G, bpf, form, act, float(count), scratch.data_ptr(),
          coef.data_ptr(), off.data_ptr(), mvn.data_ptr(), y.data_ptr())
    return y, coef, off, mvn


def backward_kernel(g3: torch.Tensor, x3: torch.Tensor, weight, bias, mvn: torch.Tensor,
                    coef: torch.Tensor, off: torch.Tensor, kind: int, G: int, act: int,
                    form: int):
    """The whole backward: in one pass where :func:`onchip_plan` admits the
    call (counted in ``norm_act_bwd.onchip``, and g's and x's bytes in the
    step's ``norm_onchip`` counter), else the two passes. (dx, dweight,
    dbias)."""
    plan = _onchip_route(x3, kind, G, True, g3, coef, off)
    if plan is None:
        return backward_two_pass(g3, x3, weight, bias, mvn, coef, off, kind, G, act, form)
    out = backward_one_pass(g3, x3, weight, mvn, coef, off, kind, G, act, plan)
    norm_act_bwd.onchip += 1
    if tracing.recording():
        tracing.count("norm_onchip", 2 * tracing.nbytes(x3))
    return out


def backward_one_pass(g3: torch.Tensor, x3: torch.Tensor, weight, mvn: torch.Tensor,
                      coef: torch.Tensor, off: torch.Tensor, kind: int, G: int, act: int,
                      plan: OnchipPlan):
    """The one-pass backward kernel under ``plan``: (dx, dweight, dbias)."""
    Fr, P, C = x3.shape
    dev = x3.device
    part = torch.empty(4 * plan.K * plan.bps * plan.W, dtype=torch.float32, device=dev)
    S = torch.empty(2 * Fr * C, dtype=torch.float32, device=dev)
    dw, db = _param_grads(weight, kind, C, dev)
    dx = torch.empty_like(x3)
    _call("uncr_norm_backward_onchip", dev, g3.data_ptr(), x3.data_ptr(), _ptr(weight),
          _code(weight), coef.data_ptr(), off.data_ptr(), mvn.data_ptr(), kind, _code(x3), Fr, P,
          C, G, plan.W, plan.K, plan.bps, plan.rpb, act, part.data_ptr(), S.data_ptr(), _ptr(dw),
          _ptr(db), dx.data_ptr())
    return dx, dw, db


def backward_two_pass(g3: torch.Tensor, x3: torch.Tensor, weight, bias, mvn: torch.Tensor,
                      coef: torch.Tensor, off: torch.Tensor, kind: int, G: int, act: int,
                      form: int):
    """The whole backward in one C call of the two-pass kernels: (dx,
    dweight, dbias)."""
    Fr, P, C = x3.shape
    dev = x3.device
    bpf = _bpf(x3, Fr, P)
    scratch = torch.empty(2 * Fr * bpf * C + 4 * Fr * C, dtype=torch.float32, device=dev)
    dw, db = _param_grads(weight, kind, C, dev)
    dx = torch.empty_like(x3)
    _call("uncr_norm_backward", dev, g3.data_ptr(), x3.data_ptr(), _ptr(weight), _ptr(bias),
          _code(weight), coef.data_ptr(), off.data_ptr(), mvn.data_ptr(), kind, _code(x3), Fr, P,
          C, G, bpf, form, act, scratch.data_ptr(), _ptr(dw), _ptr(db), dx.data_ptr())
    return dx, dw, db


class _Kernels:
    """The passes as the CUDA kernels run them."""
    stats = staticmethod(stats_kernel)
    finalize = staticmethod(finalize_kernel)
    apply = staticmethod(apply_kernel)
    bwd_stats = staticmethod(bwd_stats_kernel)
    bwd_finalize = staticmethod(bwd_finalize_kernel)
    dx = staticmethod(dx_kernel)
    forward = staticmethod(forward_kernel)
    backward = staticmethod(backward_kernel)


class _Twins:
    """The same passes through the plain twins."""

    @staticmethod
    def stats(x3, groups, extra=0):
        s = stats_twin(x3, groups).reshape(-1)
        return torch.cat([s, s.new_zeros(extra)]) if extra else s

    @staticmethod
    def finalize(sums, count, weight, bias, kind, Fr, G, C, dtype):
        return finalize_twin(sums[:2 * Fr * G].view(2, Fr, G), count, weight, bias, kind, C,
                             dtype)

    apply = staticmethod(apply_twin)
    bwd_stats = staticmethod(bwd_stats_twin)
    dx = staticmethod(dx_twin)

    @staticmethod
    def bwd_finalize(S, mvn, weight, coef, off, kind, groups):
        ab, dw, db = bwd_finalize_twin(S, mvn, weight, coef, off, kind, groups)
        if dw is not None:
            dw, db = dw.to(weight.dtype), db.to(weight.dtype)
        return ab, dw, db

    @staticmethod
    def forward(x3, weight, bias, kind, G, act, form, count):
        Fr, _, C = x3.shape
        coef, off, mvn = _Twins.finalize(_Twins.stats(x3, G), count, weight, bias, kind, Fr, G,
                                         C, _slot_dtype(x3, kind))
        return _Twins.apply(x3, coef, off, form, act, weight, bias), coef, off, mvn

    @staticmethod
    def backward(g3, x3, weight, bias, mvn, coef, off, kind, G, act, form):
        S = _Twins.bwd_stats(g3, x3, coef, off, form, act, weight, bias)
        ab, dw, db = _Twins.bwd_finalize(S, mvn, weight, coef, off, kind, G)
        return _Twins.dx(g3, x3, coef, off, ab, form, act, weight, bias), dw, db


# ------------------------------------------------- the composed passes --

def _geometry(x: torch.Tensor, kind: int, groups: int):
    """(frames, rows a frame, C, groups) of the kernels' view of x."""
    C = x.shape[-1]
    if kind in (KINDS["batch"], KINDS["batch_f32"]):
        return 1, x.numel() // C, C, C
    G = C if kind == KINDS["instance"] else groups
    return x.shape[0], x.numel() // (x.shape[0] * C), C, G


def _group(reduce: int):
    return None if reduce == REDUCE_WORLD else mesh.spatial().spatial_group


def _slot_dtype(x: torch.Tensor, kind: int) -> torch.dtype:
    """coef / off's dtype: x's, fp32 for batch_f32 (r and m)."""
    return torch.float32 if kind == KINDS["batch_f32"] else x.dtype


def _affine(weight, bias):
    """weight and bias contiguous in one dtype (the kernels read both by one
    dtype code)."""
    if weight is None:
        return None, None
    if weight.dtype != bias.dtype:
        weight, bias = weight.float(), bias.float()
    return weight.contiguous(), bias.contiguous()


def _forward(k, x, weight, bias, kind, groups, act, reduce):
    """Statistics -> [collective] -> coef / off -> apply, through the
    kernels (k = _Kernels) or their twins (_Twins); in one call where no
    collective sits between the passes. Returns (y, mvn, coef, off)."""
    Fr, P, C, G = _geometry(x, kind, groups)
    x3 = x.view(Fr, P, C)
    count = P * (C // G)
    form = FORMS[kind]
    w, b = _affine(weight, bias)
    if reduce == REDUCE_NONE:
        y3, coef, off, mvn = k.forward(x3, w, b, kind, G, act, form, count)
        return y3.view(x.shape), mvn, coef, off
    sums = k.stats(x3, G, extra=1 if reduce == REDUCE_WORLD else 0)
    if reduce == REDUCE_WORLD:  # the rows of every rank, summed with the sums
        sums[-1:].fill_(count)
        mesh.all_reduce_sum(sums)
        count = sums[-1:]
    else:  # equal bands of the scene: its count is known
        mesh.all_reduce_sum(sums, _group(reduce))
        count *= mesh.spatial().n_spatial
    coef, off, mvn = k.finalize(sums, count, w, b, kind, Fr, G, C, _slot_dtype(x, kind))
    return k.apply(x3, coef, off, form, act, w, b).view(x.shape), mvn, coef, off


def _backward(k, g, x, weight, bias, mvn, coef, off, kind, groups, act, reduce):
    """Sums of g' and g' * x -> A, B, dweight, dbias -> [collective over A,
    B] -> dx. Returns (dx, dweight, dbias), the parameters' gradients in the
    weight's dtype (empty for instance norm)."""
    Fr, P, C, G = _geometry(x, kind, groups)
    x3, g3 = x.view(Fr, P, C), g.view(Fr, P, C)
    form = FORMS[kind]
    w, b = _affine(weight, bias)
    if reduce == REDUCE_NONE:
        dx, dw, db = k.backward(g3, x3, w, b, mvn, coef, off, kind, G, act, form)
    else:
        S = k.bwd_stats(g3, x3, coef, off, form, act, w, b)
        ab, dw, db = k.bwd_finalize(S, mvn, w, coef, off, kind, G)
        ab = mesh.all_reduce_sum(ab.contiguous(), _group(reduce))
        dx = k.dx(g3, x3, coef, off, ab, form, act, w, b)
    if dw is None:
        dw, db = (x.new_empty(0, dtype=torch.float32) for _ in range(2))
    return dx.view(x.shape), dw, db


def _affine_forward(k, x, coef, off, weight, bias, act):
    """act of x * coef + off (form 0), or with weight and bias of ((x - off)
    * coef) * weight + bias in fp32 (form 2)."""
    C = x.shape[-1]
    form = 0 if weight is None else 2
    w, b = _affine(weight, bias)
    return k.apply(x.view(1, -1, C), coef.view(1, C), off.view(1, C), form, act, w,
                   b).view(x.shape)


def _affine_backward(k, g, x, coef, off, weight, bias, act):
    """(dx, dcoef, doff, dweight, dbias); dweight, dbias empty in form 0."""
    C = x.shape[-1]
    form = 0 if weight is None else 2
    w, b = _affine(weight, bias)
    x3, g3, c, o = x.view(1, -1, C), g.view(1, -1, C), coef.view(1, C), off.view(1, C)
    S = k.bwd_stats(g3, x3, c, o, form, act, w, b)
    dx = k.dx(g3, x3, c, o, None, form, act, w, b).view(x.shape)
    s1, s2 = S[0, 0], S[1, 0]
    if form == 0:
        empty = lambda: x.new_empty(0, dtype=torch.float32)
        return (dx, s2.to(coef.dtype, copy=True), s1.to(off.dtype, copy=True), empty(),
                empty())
    cf, of, wf = coef.float(), off.float(), w.float()
    t = s2 - of * s1  # sum of g' * (x - off)
    return (dx, (wf * t).to(coef.dtype), (-cf * wf * s1).to(off.dtype),
            (cf * t).to(weight.dtype), s1.to(bias.dtype, copy=True))

# -------------------------------------------------------- the operators --

@torch.library.custom_op("uncrtaints::norm_act", mutates_args=(), device_types="cuda")
def _k6(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
        kind: int, groups: int, act: int,
        reduce: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    out = _forward(_Kernels, x, weight, bias, kind, groups, act, reduce)
    norm_act.launches += 1
    return out


@_k6.register_kernel("cpu")
def norm_act_twin(x, weight, bias, kind, groups, act, reduce=REDUCE_NONE):
    """The operator's passes through the kernels' twins, on any device (its
    CPU implementation; on the card the kernels' reference)."""
    return _forward(_Twins, x, weight, bias, kind, groups, act, reduce)


@_k6.register_fake
def _k6_fake(x, weight, bias, kind, groups, act, reduce):
    Fr, _, C, G = _geometry(x, kind, groups)
    slot = lambda: x.new_empty((Fr, C), dtype=_slot_dtype(x, kind))
    return (torch.empty_like(x), x.new_empty(3 * Fr * G + 1, dtype=torch.float32), slot(),
            slot())


@torch.library.custom_op("uncrtaints::norm_act_bwd", mutates_args=(), device_types="cuda")
def _k6_bwd(g: torch.Tensor, x: torch.Tensor, weight: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], mvn: torch.Tensor, coef: torch.Tensor,
            off: torch.Tensor, kind: int, groups: int, act: int,
            reduce: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = _backward(_Kernels, g, x, weight, bias, mvn, coef, off, kind, groups, act, reduce)
    norm_act_bwd.launches += 1
    return out


@_k6_bwd.register_kernel("cpu")
def norm_act_bwd_twin(g, x, weight, bias, mvn, coef, off, kind, groups, act,
                      reduce=REDUCE_NONE):
    """The backward operator's passes through the twins, on any device."""
    return _backward(_Twins, g, x, weight, bias, mvn, coef, off, kind, groups, act, reduce)


@_k6_bwd.register_fake
def _k6_bwd_fake(g, x, weight, bias, mvn, coef, off, kind, groups, act, reduce):
    if kind == KINDS["instance"]:
        return (torch.empty_like(x), x.new_empty(0, dtype=torch.float32),
                x.new_empty(0, dtype=torch.float32))
    C = x.shape[-1]
    grad = lambda: x.new_empty(C, dtype=_affine(weight, bias)[0].dtype)
    return torch.empty_like(x), grad(), grad()


def _k6_setup(ctx, inputs, output):
    x, weight, bias, kind, groups, act, reduce = inputs
    _, mvn, coef, off = output
    ctx.save_for_backward(x, weight, bias, mvn, coef, off)
    ctx.args = (kind, groups, act, reduce)
    ctx.record = tracing.open_record()


def _k6_backward(ctx, gy, _gmvn, _gcoef, _goff):
    x, weight, bias, mvn, coef, off = ctx.saved_tensors
    n0 = norm_act_bwd.onchip
    dx, dw, db = torch.ops.uncrtaints.norm_act_bwd(gy.contiguous(), x, weight, bias, mvn, coef,
                                                   off, *ctx.args)
    # autograd runs a CUDA backward on its own thread, outside the step's
    # record: count its one pass into the record its forward saw
    if ctx.record is not None and not tracing.recording() and norm_act_bwd.onchip > n0:
        tracing.count("norm_onchip", 2 * tracing.nbytes(x), ctx.record)
    if weight is None:
        return dx, None, None, None, None, None, None
    return dx, dw.to(weight.dtype), db.to(bias.dtype), None, None, None, None


_k6.register_autograd(_k6_backward, setup_context=_k6_setup)


@torch.library.custom_op("uncrtaints::norm_affine_act", mutates_args=(), device_types="cuda")
def _k6a(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor, weight: Optional[torch.Tensor],
         bias: Optional[torch.Tensor], act: int) -> torch.Tensor:
    y = _affine_forward(_Kernels, x, coef, off, weight, bias, act)
    norm_act.launches += 1
    return y


@_k6a.register_kernel("cpu")
def affine_act_twin(x, coef, off, weight, bias, act):
    """``norm_affine_act`` through the twins, on any device."""
    return _affine_forward(_Twins, x, coef, off, weight, bias, act)


@_k6a.register_fake
def _k6a_fake(x, coef, off, weight, bias, act):
    return torch.empty_like(x)


@torch.library.custom_op("uncrtaints::norm_affine_act_bwd", mutates_args=(),
                         device_types="cuda")
def _k6a_bwd(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
             weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
             act: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    out = _affine_backward(_Kernels, g, x, coef, off, weight, bias, act)
    norm_act_bwd.launches += 1
    return out


@_k6a_bwd.register_kernel("cpu")
def affine_act_bwd_twin(g, x, coef, off, weight, bias, act):
    """``norm_affine_act_bwd`` through the twins, on any device."""
    return _affine_backward(_Twins, g, x, coef, off, weight, bias, act)


@_k6a_bwd.register_fake
def _k6a_bwd_fake(g, x, coef, off, weight, bias, act):
    if weight is None:
        empty = lambda: x.new_empty(0, dtype=torch.float32)
        return torch.empty_like(x), torch.empty_like(coef), torch.empty_like(off), empty(), empty()
    return (torch.empty_like(x), torch.empty_like(coef), torch.empty_like(off),
            torch.empty_like(weight), torch.empty_like(bias))


def _k6a_setup(ctx, inputs, output):
    x, coef, off, weight, bias, act = inputs
    ctx.save_for_backward(x, coef, off, weight, bias)
    ctx.act = act


def _k6a_backward(ctx, gy):
    x, coef, off, weight, bias = ctx.saved_tensors
    dx, dc, do, dw, db = torch.ops.uncrtaints.norm_affine_act_bwd(gy.contiguous(), x, coef, off,
                                                                  weight, bias, ctx.act)
    if weight is None:
        return dx, dc, do, None, None, None
    return dx, dc, do, dw, db, None


_k6a.register_autograd(_k6a_backward, setup_context=_k6a_setup)


# ------------------------------------- the group-norm MBConv's passes --
#
# The eval MBConv with group norms (models/blocks.py:
# MBConv._fused_group_body) runs K3 -> K4 -> K3 with a norm's passes taken
# apart around it: the statistics of the block's input ahead of the chain
# (K3's prologue normalises), the squeeze-and-excitation's pooled vector
# between K4 and the second K3, and after it the apply of the last norm,
# whose statistics that K3 takes. Eval only, as K3 and K4: no backward. x is
# [F, ..., C], F frames.

def _frames(x: torch.Tensor) -> torch.Tensor:
    return x.view(x.shape[0], -1, x.shape[-1])


def group_moments(sums: torch.Tensor, count: int):
    """(mean, rsqrt(var + eps)), each [F, G] fp32, from sums [2, F, G] (of x,
    of x^2) over ``count`` elements a group: K6's formula
    (norm_finalize_kernel), var = E[x^2] - E[x]^2 clamped at 0."""
    mean, sq = sums / count
    return mean, torch.rsqrt(torch.clamp(sq - mean * mean, min=0.0) + EPS)


def group_affine(mean: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, dtype: torch.dtype):
    """A group norm's coef, off [F, C] in ``dtype`` from its (mean, rstd)
    [F, G]: rstd * weight and bias - mean * coef in fp32, rounded once
    (:func:`finalize_twin`'s group norm)."""
    cg = weight.shape[0] // mean.shape[1]
    cf = rstd.repeat_interleave(cg, -1) * weight.float()
    of = bias.float() - mean.repeat_interleave(cg, -1) * cf
    return cf.to(dtype), of.to(dtype)


def gelu_pool_twin(x3: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[F, C] fp32: per frame and channel the sum over the rows of
    gelu(((x - m) * r) * scale + bias) in fp32, m and r = ``mean``, ``coef``
    [F, G] of the channel's group (K3's prologue)."""
    C, G = x3.shape[-1], mean.shape[1]
    m = mean.float().repeat_interleave(C // G, -1)[:, None, :]
    r = coef.float().repeat_interleave(C // G, -1)[:, None, :]
    return F.gelu((x3.float() - m) * r * scale.float() + bias.float()).sum(dim=1)


def gelu_pool_kernel(x3: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`gelu_pool_twin`: per-block partial rows (twice
    the statistics' blocks a frame: an erf an element), then their fixed-order
    sum."""
    Fr, P, C = x3.shape
    G = mean.shape[1]
    bpf = _bpf(x3, Fr, P, 2 * _BLOCKS_PER_SM)
    part = torch.empty(Fr * bpf * C, dtype=torch.float32, device=x3.device)
    out = torch.empty((Fr, C), dtype=torch.float32, device=x3.device)
    _call("uncr_norm_gelu_pool", x3.device, x3.data_ptr(), _code(x3), Fr, P, C, G,
          mean.data_ptr(), coef.data_ptr(), scale.data_ptr(), bias.data_ptr(), bpf,
          part.data_ptr(), out.data_ptr())
    return out


@torch.library.custom_op("uncrtaints::norm_stats", mutates_args=(), device_types="cuda")
def _k6_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    out = stats_kernel(_frames(x), groups).view(2, x.shape[0], groups)
    norm_stats.launches += 1
    return out


@_k6_stats.register_kernel("cpu")
def _k6_stats_cpu(x, groups):
    return stats_twin(_frames(x), groups)


@_k6_stats.register_fake
def _k6_stats_fake(x, groups):
    return x.new_empty((2, x.shape[0], groups), dtype=torch.float32)


@torch.library.custom_op("uncrtaints::norm_apply", mutates_args=(), device_types="cuda")
def _k6_apply(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    y = apply_kernel(_frames(x), coef, off, 0, ACTS["none"]).view(x.shape)
    norm_apply.launches += 1
    return y


@_k6_apply.register_kernel("cpu")
def _k6_apply_cpu(x, coef, off):
    return apply_twin(_frames(x), coef, off, 0, ACTS["none"]).view(x.shape)


@_k6_apply.register_fake
def _k6_apply_fake(x, coef, off):
    return torch.empty_like(x)


@torch.library.custom_op("uncrtaints::norm_gelu_pool", mutates_args=(), device_types="cuda")
def _k6_pool(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    out = gelu_pool_kernel(_frames(x), mean, coef, scale, bias)
    norm_gelu_pool.launches += 1
    return out


@_k6_pool.register_kernel("cpu")
def _k6_pool_cpu(x, mean, coef, scale, bias):
    return gelu_pool_twin(_frames(x), mean, coef, scale, bias)


@_k6_pool.register_fake
def _k6_pool_fake(x, mean, coef, scale, bias):
    return x.new_empty((x.shape[0], x.shape[-1]), dtype=torch.float32)


# --------------------------------------------------------- the wrappers --

def _check(name: str, x: torch.Tensor, C: int, *small) -> None:
    if x.dim() < 2:
        raise ValueError(f"{name}: x [..., C] of two or more axes expected, got {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in small:
        if t is not None and (tuple(t.shape) != (C,) or t.device != x.device):
            raise ValueError(f"{name}: per-channel vectors [{C}] on {x.device} expected, got "
                             f"{tuple(t.shape)} on {t.device}")


def norm_act(x: torch.Tensor, kind: str, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, groups: int = 4, act: str = "none"):
    """Norm ``kind`` (batch in train mode, group of ``groups``, instance, or
    ``batch_f32``: the L-TAE form's train-mode batch norm with its affine in
    fp32) of x [..., C] (group and instance: [N, H, W, C]) with the
    statistics of x, the affine (``weight``, ``bias`` [C]; none for instance
    norm) and ``act`` (none, gelu, relu, leaky_relu) after it.

    Returns (y, mean, var, count): the statistics as :func:`norm_act_plain`
    gives them (on the card batch norm's mean and clamped variance [C],
    group and instance norm's [N, G]), count the rows behind batch norm's
    statistics (an int; a tensor on the card under a process group).

    A CPU tensor runs :func:`norm_act_plain`; a CUDA tensor the kernels
    through ``torch.ops.uncrtaints.norm_act`` (differentiable: its backward
    is ``norm_act_bwd``), which raise on what they do not take. Under a
    process group (batch) or a spatial split (group, instance) the sums are
    reduced over the ranks inside the operator, both ways.
    ``norm_act.launches`` counts the forwards on the card, of this and of
    :func:`affine_act`; ``norm_act.onchip`` those that took one pass."""
    if kind not in KINDS:
        raise ValueError(f"norm_act: unknown norm {kind!r} ({', '.join(KINDS)})")
    if act not in ACTS:
        raise ValueError(f"norm_act: unknown activation {act!r} ({', '.join(ACTS)})")
    C = x.shape[-1]
    _check("norm_act", x, C, weight, bias)
    if (kind == "instance") != (weight is None and bias is None):
        raise ValueError("norm_act: batch and group norms take a weight and a bias, instance "
                         "norm neither")
    if kind == "group" and C % groups:
        raise ValueError(f"norm_act: {C} channels in {groups} groups is not whole")
    if kind in ("group", "instance") and x.dim() != 4:
        raise ValueError(f"norm_act: {kind} norm takes x [N,H,W,C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return norm_act_plain(x, kind, weight, bias, groups, act)
    if x.numel() == 0:
        raise ValueError("norm_act: an empty map has no statistics")
    return norm_act_operator(x, kind, weight, bias, groups, act)


def norm_act_operator(x: torch.Tensor, kind: str, weight: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, groups: int = 4,
                      act: str = "none"):
    """:func:`norm_act` through ``torch.ops.uncrtaints.norm_act`` whatever
    x's device (the route of a CUDA tensor; on a CPU tensor the operator runs
    the kernels' twins, which the tests use)."""
    C = x.shape[-1]
    batch = kind in ("batch", "batch_f32")
    if batch:
        reduce = REDUCE_WORLD if mesh.active() else REDUCE_NONE
    else:
        reduce = REDUCE_SPATIAL if mesh.spatial() is not None else REDUCE_NONE
    y, mvn, _, _ = torch.ops.uncrtaints.norm_act(
        x.contiguous(), weight, bias, KINDS[kind], groups, ACTS[act], reduce)
    Fr, _, _, G = _geometry(x, KINDS[kind], groups)
    FG = Fr * G
    m, v = mvn[:FG].view(Fr, G), mvn[FG:2 * FG].view(Fr, G)
    if not batch:
        return y, m, v, None
    n = mvn[3 * FG] if reduce == REDUCE_WORLD else x.numel() // C
    return y, m.view(C), v.view(C), n


def affine_act(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
               act: str = "none", weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(x * coef + off) for x [..., C] and coef, off [C] in x's dtype (the
    eval batch norm's folded affine); with ``weight`` and ``bias`` [C],
    act(((x - off) * coef) * weight + bias) in fp32 with coef, off fp32 (the
    L-TAE form's eval batch norm: r and the running mean). A CPU tensor
    through :func:`affine_act_plain`, a CUDA tensor through the kernel
    (``torch.ops.uncrtaints.norm_affine_act``, differentiable; counted in
    ``norm_act.launches``)."""
    if act not in ACTS:
        raise ValueError(f"affine_act: unknown activation {act!r} ({', '.join(ACTS)})")
    C = x.shape[-1]
    _check("affine_act", x, C, coef, off, weight, bias)
    want = x.dtype if weight is None else torch.float32
    if coef.dtype != want or off.dtype != want or (weight is None) != (bias is None):
        raise TypeError(f"affine_act: coef and off in {want} (and a weight with a bias) "
                        f"expected, got {coef.dtype}, {off.dtype}")
    if x.device.type == "cpu":
        return affine_act_plain(x, coef, off, act, weight, bias)
    if x.numel() == 0:
        raise ValueError("affine_act: an empty map")
    return affine_act_operator(x, coef, off, act, weight, bias)


def affine_act_operator(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor,
                        act: str = "none", weight: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`affine_act` through ``torch.ops.uncrtaints.norm_affine_act``
    whatever x's device (see :func:`norm_act_operator`)."""
    return torch.ops.uncrtaints.norm_affine_act(x.contiguous(), coef.contiguous(),
                                                off.contiguous(), weight, bias, ACTS[act])


def norm_act_bwd(g: torch.Tensor, x: torch.Tensor, weight: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], mvn: torch.Tensor, coef: torch.Tensor,
                 off: torch.Tensor, kind: str, groups: int = 4, act: str = "none"):
    """The backward of :func:`norm_act` on the card, as its autograd runs it
    (``torch.ops.uncrtaints.norm_act_bwd``): (dx, dweight, dbias) from the
    output gradient g and what the forward operator returned (mvn, coef,
    off). No collective (one process). ``norm_act_bwd.launches`` counts the
    backward launches, of this operator and of :func:`affine_act`'s;
    ``norm_act_bwd.onchip`` those that took one pass."""
    return torch.ops.uncrtaints.norm_act_bwd(g.contiguous(), x.contiguous(), weight, bias, mvn,
                                             coef, off, KINDS[kind], groups, ACTS[act],
                                             REDUCE_NONE)


def _check_frames(name: str, x: torch.Tensor, *small: torch.Tensor) -> None:
    """x [F, ..., C] on the CPU or the card; on the card no input may ask for
    a gradient (the passes have none, as K3 and K4)."""
    _check(name, x, x.shape[-1])
    if x.dim() < 3 or x.numel() == 0:
        raise ValueError(f"{name}: x [F, ..., C] of frames of rows expected, got {tuple(x.shape)}")
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, *small))):
        raise RuntimeError(f"{name}: the eval pass has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")


def _per_group(name: str, x: torch.Tensor, groups: int, *small: torch.Tensor):
    """The [F, G] vectors as the kernels read them: fp32, contiguous, on x's
    device."""
    if groups < 1 or x.shape[-1] % groups:
        raise ValueError(f"{name}: {x.shape[-1]} channels in {groups} groups is not whole")
    for t in small:
        if tuple(t.shape) != (x.shape[0], groups) or t.device != x.device:
            raise ValueError(f"{name}: [{x.shape[0]}, {groups}] on {x.device} expected, got "
                             f"{tuple(t.shape)} on {t.device}")
    return [t.float().contiguous() for t in small]


def norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[2, F, G] fp32: the sums of x and of x^2 per frame and group of x [F,
    ..., C] (``torch.ops.uncrtaints.norm_stats``: on the card K6's statistics
    pass, per-block partials and their fixed-order sum; on the CPU
    :func:`stats_twin`). ``norm_stats.launches`` counts the card's calls."""
    _check_frames("norm_stats", x)
    _per_group("norm_stats", x, groups)
    return torch.ops.uncrtaints.norm_stats(x.contiguous(), groups)


def norm_apply(x: torch.Tensor, coef: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """x * coef + off, each operation in x's dtype, for x [F, ..., C] and
    coef, off [F, C] in x's dtype (a group norm's apply with its (frame,
    channel) affine, :func:`group_affine`; on the card K6's apply pass, on
    the CPU :func:`apply_twin`). ``norm_apply.launches`` counts the card's
    calls."""
    _check_frames("norm_apply", x, coef, off)
    want = (x.shape[0], x.shape[-1])
    if any(tuple(t.shape) != want or t.dtype != x.dtype or t.device != x.device
           for t in (coef, off)):
        raise ValueError(f"norm_apply: coef and off {list(want)} in {x.dtype} on {x.device} "
                         f"expected, got {tuple(coef.shape)} {coef.dtype}, {tuple(off.shape)} "
                         f"{off.dtype}")
    return torch.ops.uncrtaints.norm_apply(x.contiguous(), coef.contiguous(), off.contiguous())


def norm_gelu_pool(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[F, C] fp32: per frame and channel of x [F, ..., C] the sum over the
    frame's pixels of gelu(((x - m) * r) * scale + bias), m and r = ``mean``,
    ``coef`` [F, G] of the channel's group, scale and bias [C] (the eval
    group-norm MBConv's squeeze-and-excitation sum, with K3's prologue). On
    the card the read-only pass ``uncr_norm_gelu_pool`` of csrc/norm.cu, its
    partials summed in a fixed order (no atomics: two calls give the same
    bits); on the CPU :func:`gelu_pool_twin`. ``norm_gelu_pool.launches``
    counts the card's calls."""
    _check_frames("norm_gelu_pool", x, mean, coef, scale, bias)
    C = x.shape[-1]
    _check("norm_gelu_pool", x, C, scale, bias)
    mean, coef = _per_group("norm_gelu_pool", x, mean.shape[-1], mean, coef)
    return torch.ops.uncrtaints.norm_gelu_pool(x.contiguous(), mean, coef,
                                               scale.float().contiguous(),
                                               bias.float().contiguous())


norm_act.launches = 0
norm_act_bwd.launches = 0
norm_act.onchip = 0
norm_act_bwd.onchip = 0
norm_stats.launches = 0
norm_apply.launches = 0
norm_gelu_pool.launches = 0

