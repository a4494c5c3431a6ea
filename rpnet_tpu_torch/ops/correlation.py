"""RAFT-style local correlation: the plain version and the kernel's wrapper.

    out[b, y, x, dx·d + dy] = cast(scale · Σ_c f32(fm1[b, y, x, c])
                                          · f32(fm2[b, y+dy-r, x+dx-r, c]))

with d = 2r+1, scale = f32(1/√C), zeros outside the image, the sum taken in
float32 and rounded once to the input dtype. The channel order c = dx·d + dy
(horizontal shift slowest) is the reference quirk that
``rpnet_tpu/ops/correlation.py:27-50`` documents; the CRE's 1×1 conv weights
depend on it.

:func:`local_correlation_plain` is the shifted-products formula in PyTorch.
:func:`local_correlation` is the forward's wrapper: a CPU tensor goes to the
plain version; a CUDA tensor goes to the Hopper kernel
(``ops/csrc/local_corr.cu``, built by ``ops/kernels.py``) or raises.

Custom ops. Each forward wrapper below calls a ``torch.library.custom_op``
of the namespace ``rpnet_torch`` (``local_corr``, ``local_corr_band``,
``local_corr_pdot``, ``local_corr_packed``, ``local_corr_csub``) whose CPU
implementation is the plain version and whose CUDA implementation checks
the inputs, launches the kernel and counts the launch on the wrapper
(``<wrapper>.launches``); its fake implementation gives the output's shape
and dtype. So ``torch.export`` records the correlation as one graph node,
and an exported program launches the hand-written kernel on the card and
counts it as the live path does (``serve/export.py``). The backward stays
behind the autograd Function :class:`LocalCorrelation`.

The backward, in the gathered form of ``_corr_bwd_kernel``
(``rpnet_tpu/ops/pallas/correlation.py:776``), with δ = (dy−r, dx−r):

    dfm1[p, c] = scale · Σ_{dx,dy} g[p, dx·d+dy] · fm2[p+δ, c]
    dfm2[q, c] = scale · Σ_{dx,dy} g[q−δ, dx·d+dy] · fm1[q−δ, c]

summed in float32 and rounded once to the input dtype, has the same pair:
:func:`local_correlation_bwd_plain` and the wrapper
:func:`local_correlation_bwd` (``ops/csrc/local_corr_bwd.cu``).
:class:`LocalCorrelation` is the autograd Function over a forward wrapper
and the backward wrapper; the CRE calls it through
:func:`local_correlation_trainable`.

Opt-in forwards. The JAX package has four more Pallas forwards of the same
function, chosen by environment variables; the port reads the same
variables, with the same meaning, in :func:`correlation_route` (once per
call), and gives each its own Hopper kernel, plain version and wrapper:

* select — ``_corr_rot_kernel`` (select) and ``_corr_kernel``:
  ``local_corr.cu``, :func:`local_correlation`;
* band — ``_corr_mxu_kernel`` (``RPNET_CORR_IMPL=pallas_mxu``):
  ``local_corr_band.cu``, :func:`local_correlation_band`;
* pdot — ``_corr_rot_kernel`` with ``pdot=True`` (``RPNET_ROT_EXTRACT=pdot``):
  ``local_corr_band.cu``, :func:`local_correlation_pdot`;
* pack — ``_corr_rot2_kernel`` (``RPNET_ROT_PACK=1``): ``local_corr_band.cu``,
  :func:`local_correlation_packed` behind :func:`local_correlation_pack`;
* csub — ``_corr_csub_kernel`` (``RPNET_CORR_IMPL=csub``):
  ``local_corr_csub.cu``, :func:`local_correlation_csub`.

Every route returns the quirk order (B, H, W, d²) in fm1's dtype; the TPU's
rot layout (128 lanes, dy-major, dx reversed) is not carried. ``pdot`` keeps
its own value contract (two bf16 roundings, :func:`local_correlation_pdot_plain`);
the others compute the function above. The one backward serves them all.
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

MAX_RADIUS = 5     # the kernel is instantiated for r = 1..5
CHANNEL_STEP = 16  # C must be a multiple (the kernels' channel staging steps)
CORR_IMPLS = ("pallas", "rot", "pallas_mxu", "csub")   # RPNET_CORR_IMPL values carried


def correlation_scale(C: int) -> float:
    """1/√C rounded to float32, as the JAX kernel applies it."""
    return float(np.float32(1.0 / np.sqrt(float(C))))


def _corr_sums(fm1: torch.Tensor, fm2: torch.Tensor, r: int,
               width: int = 0) -> torch.Tensor:
    """The unscaled f32 sums (B, H, W, d²) in quirk order. ``width`` > 0
    reads the W axis as slices of that width side by side: a source column
    outside the query's own slice counts as zero."""
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    a = fm1.float()
    pad = F.pad(fm2.float(), (0, 0, r, r, r, r))   # zero rows/cols around the image
    col = torch.arange(W, device=fm1.device) % (width or W)
    out = torch.empty((B, H, W, d * d), dtype=torch.float32, device=fm1.device)
    for dx in range(d):        # horizontal shift — slow axis (reference quirk)
        src = col + dx - r
        inside = ((src >= 0) & (src < (width or W)))[:, None]   # (W, 1)
        for dy in range(d):    # vertical shift — fast axis
            prod = a * pad[:, dy:dy + H, dx:dx + W, :]
            if width:
                prod = torch.where(inside, prod, 0.0)
            out[..., dx * d + dy] = prod.sum(-1)
    return out


def local_correlation_plain(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """Shifted-products local correlation. fm1, fm2: (B, H, W, C) → (B, H, W, d²)."""
    return (_corr_sums(fm1, fm2, r) * correlation_scale(fm1.shape[-1])).to(fm1.dtype)


def _check_kernel_inputs(name: str, fm1: torch.Tensor, fm2: torch.Tensor,
                         r: int, max_batch: int, c_dim: int = 3) -> None:
    """Raise unless fm1, fm2 are what the Hopper kernels take: channels-last
    (B, H, W, C), or (B, H, C, W) with ``c_dim`` 2."""
    layout = "channels-last (B, H, W, C)" if c_dim == 3 else "(B, H, C, W)"
    if fm1.device.type != "cuda" or fm2.device != fm1.device:
        raise ValueError(f"{name}: tensors on {fm1.device} and "
                         f"{fm2.device}; the kernel needs both on one CUDA device")
    if fm1.dtype != fm2.dtype or fm1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtypes {fm1.dtype}/{fm2.dtype}; "
                         "the kernel takes float32 or bfloat16, the same for both")
    if fm1.dim() != 4 or fm1.shape != fm2.shape:
        raise ValueError(f"{name}: shapes {tuple(fm1.shape)} and "
                         f"{tuple(fm2.shape)}; the kernel needs equal {layout}")
    if not (fm1.is_contiguous() and fm2.is_contiguous()):
        raise ValueError(f"{name}: the kernel needs contiguous {layout} tensors")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"{name}: radius {r} outside the kernel's "
                         f"1..{MAX_RADIUS}")
    B, C = fm1.shape[0], fm1.shape[c_dim]
    if B > max_batch:
        raise ValueError(f"{name}: batch {B} exceeds the kernel's "
                         f"grid ({max_batch})")
    if C % CHANNEL_STEP or fm1.data_ptr() % 16 or fm2.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels stage channels in steps of up to "
                         f"{CHANNEL_STEP} with aligned vector loads; they need C "
                         f"a multiple of {CHANNEL_STEP} (got {C}) and 16-byte "
                         "aligned tensors")


OP_NAMESPACE = "rpnet_torch"
_SCHEMA = "(Tensor fm1, Tensor fm2, int r) -> Tensor"


def _corr_op(name: str, plain, kernel, out_shape, schema: str = _SCHEMA):
    """Register ``rpnet_torch::<name>``: ``plain`` on CPU tensors, ``kernel``
    (checks, launch, count) on CUDA tensors, and a fake implementation of
    ``out_shape(input shape, r)`` in fm1's dtype for tracing. Another device
    raises (no implementation), as does a CUDA input the kernel cannot
    take."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(kernel)
    op.register_fake(lambda fm1, fm2, r, *rest: fm1.new_empty(out_shape(tuple(fm1.shape), r)))
    return op


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise for a device the op has no implementation of (a meta tensor
    would take the fake one)."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: a tensor on {t.device}; the plain version "
                             "takes CPU tensors, the kernel CUDA tensors")


def _nhwc_out(shape, r):
    return shape[:3] + ((2 * r + 1) ** 2,)


def _local_corr_cuda(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    _check_kernel_inputs("local_correlation", fm1, fm2, r, max_batch=65535)
    from rpnet_tpu_torch.ops import kernels

    B, H, W, C = fm1.shape
    out = torch.empty(_nhwc_out((B, H, W), r), dtype=fm1.dtype, device=fm1.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr(fm1, fm2, out, r, correlation_scale(C))
    local_correlation.launches += 1
    return out


_local_corr_op = _corr_op("local_corr", local_correlation_plain, _local_corr_cuda, _nhwc_out)


def local_correlation(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """Local correlation; the Hopper kernel for CUDA tensors (see module doc),
    through the custom op ``rpnet_torch::local_corr``."""
    _check_device("local_correlation", fm1, fm2)
    return _local_corr_op(fm1, fm2, r)


local_correlation.launches = 0   # kernel launches (the plain path never counts)


def _launch_band(wrapper, mode: str, fm1: torch.Tensor, fm2: torch.Tensor, r: int,
                 width: int) -> torch.Tensor:
    """Launch ``local_corr_band.cu`` in ``mode``; counts on ``wrapper``."""
    from rpnet_tpu_torch.ops import kernels

    B, H, W, C = fm1.shape
    out = torch.empty((B, H, W, (2 * r + 1) ** 2), dtype=fm1.dtype, device=fm1.device)
    if out.numel():
        kernels.launch_local_corr_band(mode, fm1, fm2, out, r, width,
                                       correlation_scale(C))
        wrapper.launches += 1
    return out


def _band_cuda(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    _check_kernel_inputs("local_correlation_band", fm1, fm2, r, max_batch=65535)
    return _launch_band(local_correlation_band, "band", fm1, fm2, r, fm1.shape[2])


_band_op = _corr_op("local_corr_band", local_correlation_plain, _band_cuda, _nhwc_out)


def local_correlation_band(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """The ``pallas_mxu`` forward: the function of :func:`local_correlation_plain`
    as a tensor-core band product (``ops/csrc/local_corr_band.cu``) on CUDA
    tensors; a CPU tensor goes to the plain version. The custom op
    ``rpnet_torch::local_corr_band``."""
    _check_device("local_correlation_band", fm1, fm2)
    return _band_op(fm1, fm2, r)


local_correlation_band.launches = 0


def _require_bf16(name: str, fm1: torch.Tensor) -> None:
    if fm1.dtype != torch.bfloat16:
        raise ValueError(f"{name}: {fm1.dtype} input; the pdot value contract "
                         "(RPNET_ROT_EXTRACT=pdot) is defined for bfloat16 only")


def local_correlation_pdot_plain(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """The TPU pdot extraction's values, bf16 only:
    ``bf16(f32(bf16(S)) · f32(bf16(scale)))`` with S the f32 channel sum.
    Its main dot rounds S to bf16 at the output, and the placement matrix
    holds the scale in bf16 (``_rot_extract_matrix``); one nonzero product
    per output column makes the second dot exact before its rounding. For a
    power-of-two scale (C = 4^k) this equals :func:`local_correlation_plain`."""
    _require_bf16("local_correlation_pdot", fm1)
    scale = float(torch.tensor(correlation_scale(fm1.shape[-1]), dtype=torch.bfloat16))
    s = _corr_sums(fm1, fm2, r).to(torch.bfloat16).float()
    return (s * scale).to(torch.bfloat16)


def _pdot_cuda(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    _require_bf16("local_correlation_pdot", fm1)
    _check_kernel_inputs("local_correlation_pdot", fm1, fm2, r, max_batch=65535)
    return _launch_band(local_correlation_pdot, "pdot", fm1, fm2, r, fm1.shape[2])


_pdot_op = _corr_op("local_corr_pdot", local_correlation_pdot_plain, _pdot_cuda, _nhwc_out)


def local_correlation_pdot(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """The ``RPNET_ROT_EXTRACT=pdot`` forward: the band product with the
    pdot epilogue (``ops/csrc/local_corr_band.cu``) on CUDA tensors; a CPU
    tensor goes to :func:`local_correlation_pdot_plain`. The custom op
    ``rpnet_torch::local_corr_pdot``."""
    _require_bf16("local_correlation_pdot", fm1)
    _check_device("local_correlation_pdot", fm1, fm2)
    return _pdot_op(fm1, fm2, r)


local_correlation_pdot.launches = 0


def pack_pairs(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B/2, H, 2W, C): consecutive slices side by side
    (``_pack_pairs``)."""
    B, H, W, C = a.shape
    return a.reshape(B // 2, 2, H, W, C).transpose(1, 2).reshape(B // 2, H, 2 * W, C)


def unpack_pairs(a: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_pairs` (``_unpack_pairs``)."""
    Bh, H, W2, C = a.shape
    return a.reshape(Bh, H, 2, W2 // 2, C).transpose(1, 2).reshape(2 * Bh, H, W2 // 2, C)


def local_correlation_packed_plain(fm1p: torch.Tensor, fm2p: torch.Tensor, r: int,
                                   width: int) -> torch.Tensor:
    """The packed kernel's function on the packed layout (B/2, H, 2W, C):
    each query correlates with its own slice only; a source column in the
    partner slice counts as zero (``_corr_rot2_kernel``'s validity mask)."""
    sums = _corr_sums(fm1p, fm2p, r, width=width)
    return (sums * correlation_scale(fm1p.shape[-1])).to(fm1p.dtype)


def _packed_cuda(fm1p: torch.Tensor, fm2p: torch.Tensor, r: int,
                 width: int) -> torch.Tensor:
    _check_kernel_inputs("local_correlation_packed", fm1p, fm2p, r, max_batch=65535)
    if fm1p.shape[2] != 2 * width:
        raise ValueError(f"local_correlation_packed: packed width {fm1p.shape[2]} "
                         f"is not two slices of {width}")
    return _launch_band(local_correlation_packed, "pack", fm1p, fm2p, r, width)


_packed_op = _corr_op("local_corr_packed", local_correlation_packed_plain, _packed_cuda,
                      _nhwc_out, schema="(Tensor fm1, Tensor fm2, int r, int width) -> Tensor")


def local_correlation_packed(fm1p: torch.Tensor, fm2p: torch.Tensor, r: int,
                             width: int) -> torch.Tensor:
    """Slice pairs packed side by side (B/2, H, 2W, C) → (B/2, H, 2W, d²):
    the band kernel with the partner mask (``ops/csrc/local_corr_band.cu``)
    on CUDA tensors; a CPU tensor goes to :func:`local_correlation_packed_plain`.
    The custom op ``rpnet_torch::local_corr_packed``."""
    _check_device("local_correlation_packed", fm1p, fm2p)
    return _packed_op(fm1p, fm2p, r, width)


local_correlation_packed.launches = 0


def local_correlation_pack(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """The ``RPNET_ROT_PACK=1`` forward on (B, H, W, C), B even: pack slice
    pairs, correlate, unpack (the JAX wrapper's ``_pack_pairs`` round trip)."""
    W = fm1.shape[2]
    out = local_correlation_packed(pack_pairs(fm1), pack_pairs(fm2), r, W)
    return unpack_pairs(out)


def local_correlation_csub_plain(fm1t: torch.Tensor, fm2t: torch.Tensor, r: int) -> torch.Tensor:
    """The local correlation on the C-strided layout: fm1t, fm2t (B, H, C, W)
    → (B, H, W, d²) quirk order in fm1t's dtype."""
    return local_correlation_plain(fm1t.transpose(2, 3), fm2t.transpose(2, 3), r)


def _csub_cuda(fm1t: torch.Tensor, fm2t: torch.Tensor, r: int) -> torch.Tensor:
    _check_kernel_inputs("local_correlation_csub", fm1t, fm2t, r, max_batch=65535,
                         c_dim=2)
    B, H, C, W = fm1t.shape
    from rpnet_tpu_torch.ops import kernels

    out = torch.empty((B, H, W, (2 * r + 1) ** 2), dtype=fm1t.dtype, device=fm1t.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr_csub(fm1t, fm2t, out, r, correlation_scale(C))
    local_correlation_csub.launches += 1
    return out


_csub_op = _corr_op("local_corr_csub", local_correlation_csub_plain, _csub_cuda,
                    lambda shape, r: (shape[0], shape[1], shape[3], (2 * r + 1) ** 2))


def local_correlation_csub(fm1t: torch.Tensor, fm2t: torch.Tensor, r: int) -> torch.Tensor:
    """The ``csub`` kernel (``ops/csrc/local_corr_csub.cu``) on the layout of
    ``_corr_csub_kernel``: fm1t, fm2t (B, H, C, W), W contiguous →
    (B, H, W, d²). A CPU tensor goes to :func:`local_correlation_csub_plain`;
    a CUDA tensor in any other layout raises. The custom op
    ``rpnet_torch::local_corr_csub``."""
    _check_device("local_correlation_csub", fm1t, fm2t)
    return _csub_op(fm1t, fm2t, r)


local_correlation_csub.launches = 0


def _csub_forward(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) → the csub kernel's (B, H, C, W), as the JAX wrapper
    transposes before its kernel."""
    return local_correlation_csub(fm1.transpose(2, 3).contiguous(),
                                  fm2.transpose(2, 3).contiguous(), r)


FORWARDS = {"select": local_correlation, "band": local_correlation_band,
            "pdot": local_correlation_pdot, "pack": local_correlation_pack,
            "csub": _csub_forward}


def forward_launches() -> int:
    """The launches counted so far by every forward wrapper (select, band,
    pdot, packed, csub): read around a piece of work, the forward kernel
    launches it made."""
    return sum(w.launches for w in (local_correlation, local_correlation_band,
                                    local_correlation_pdot, local_correlation_packed,
                                    local_correlation_csub))


@functools.lru_cache(maxsize=None)
def _warn_pdot_ignored(reason: str) -> None:
    warnings.warn(f"RPNET_ROT_EXTRACT=pdot requested but ignored: {reason}; "
                  "falling back to the select extraction.", stacklevel=3)


def correlation_route(fm1: torch.Tensor, r: int, training: bool) -> str:
    """The forward the JAX package would run for this call, a key of
    :data:`FORWARDS`. Resolved per call from the JAX package's variables:

    * ``RPNET_CORR_IMPL``: unset, ``pallas``, ``rot``, ``pallas_mxu`` or
      ``csub`` (``rpnet_tpu/models/cre.py:72-79``, ``local_correlation_auto``);
      ``pallas_mxu`` → band, ``csub`` → csub in either mode. The rot family
      runs in eval when the variable is unset or ``rot``, and in training
      under ``rot`` (``_rot_quirk``), and needs W + 2r ≤ 128 and d² ≤ 128:
      unset, eval falls back to select; ``rot`` raises, as the JAX kernel
      does. Everything else is select.
    * In the rot family (``local_correlation_pallas_rot``):
      ``RPNET_ROT_PACK=1`` with B even and 2W = 128 → pack; else
      ``RPNET_ROT_EXTRACT=pdot`` with bf16 → pdot (warned once when set but
      shadowed by pack or given f32); else select.

    The JAX package's other values (``xla``, ``mxu``, ``fake``) are XLA
    formulations or a timing stub, not kernels; they raise here.
    """
    impl = os.environ.get("RPNET_CORR_IMPL")
    if impl is not None and impl not in CORR_IMPLS:
        raise ValueError(f"RPNET_CORR_IMPL={impl!r}: the port carries "
                         f"{', '.join(CORR_IMPLS)} (or unset)")
    if impl == "pallas_mxu":
        return "band"
    if impl == "csub":
        return "csub"
    if impl != "rot" and (impl is not None or training):
        return "select"
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    if W + 2 * r > 128 or d * d > 128:
        if impl == "rot":
            raise ValueError("RPNET_CORR_IMPL=rot: the rotate variant assumes "
                             f"W+2r <= 128 and (2r+1)² <= 128 (W={W}, r={r})")
        return "select"
    pack = B % 2 == 0 and 2 * W == 128 and os.environ.get("RPNET_ROT_PACK", "0") == "1"
    pdot_asked = os.environ.get("RPNET_ROT_EXTRACT", "") == "pdot"
    if pack:
        if pdot_asked:
            _warn_pdot_ignored("RPNET_ROT_PACK=1 takes precedence")
        return "pack"
    if pdot_asked:
        if fm1.dtype == torch.bfloat16:
            return "pdot"
        _warn_pdot_ignored("output dtype is f32 (the bf16-width value "
                           "contract does not hold)")
    return "select"


def local_correlation_bwd_plain(g: torch.Tensor, fm1: torch.Tensor,
                                fm2: torch.Tensor, r: int):
    """Both input gradients in the gathered form (see module doc).

    g (B, H, W, d²) in quirk order; fm1, fm2 (B, H, W, C) → (dfm1, dfm2).
    """
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    pad = (0, 0, r, r, r, r)                 # zero rows/cols around the image
    gf = g.float()
    gp = F.pad(gf, pad)
    fm1p = F.pad(fm1.float(), pad)
    fm2p = F.pad(fm2.float(), pad)
    dfm1 = torch.zeros((B, H, W, C), dtype=torch.float32, device=fm1.device)
    dfm2 = torch.zeros_like(dfm1)
    for dx in range(d):
        for dy in range(d):
            k = dx * d + dy
            # dfm1[p] += g[p, k] · fm2[p + δ]
            dfm1 += gf[..., k:k + 1] * fm2p[:, dy:dy + H, dx:dx + W]
            # dfm2[q] += g[q − δ, k] · fm1[q − δ]; q − δ = q + (r−dy, r−dx)
            ys, xs = 2 * r - dy, 2 * r - dx
            dfm2 += gp[:, ys:ys + H, xs:xs + W, k:k + 1] * fm1p[:, ys:ys + H, xs:xs + W]
    scale = correlation_scale(C)
    return (dfm1 * scale).to(fm1.dtype), (dfm2 * scale).to(fm2.dtype)


def local_correlation_bwd(g: torch.Tensor, fm1: torch.Tensor, fm2: torch.Tensor,
                          r: int):
    """The backward; the Hopper kernel for CUDA tensors (see module doc).

    The kernel reads g with its pixel stride: the CRE's ``torch.cat([corr,
    fm1])`` hands back g as a (B, H, W, d²) view of a (B, H, W, d²+C)
    gradient, which it takes as it is. A g whose pixels are not evenly
    strided is copied first.
    """
    if all(t.device.type == "cpu" for t in (g, fm1, fm2)):
        return local_correlation_bwd_plain(g, fm1, fm2, r)
    _check_kernel_inputs("local_correlation_bwd", fm1, fm2, r, max_batch=32767)
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    if g.device != fm1.device or g.dtype != fm1.dtype or g.shape != (B, H, W, d * d):
        raise ValueError(f"local_correlation_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"on {g.device}; the kernel needs ({B}, {H}, {W}, {d * d}) "
                         f"{fm1.dtype} on {fm1.device}")
    pitch = g.stride(2)
    if g.stride() != (H * W * pitch, W * pitch, pitch, 1) or pitch < d * d:
        g = g.contiguous()
        pitch = d * d
    from rpnet_tpu_torch.ops import kernels

    dfm1 = torch.empty_like(fm1)
    dfm2 = torch.empty_like(fm2)
    if dfm1.numel() == 0:
        return dfm1, dfm2
    kernels.launch_local_corr_bwd(g, pitch, fm1, fm2, dfm1, dfm2, r,
                                  correlation_scale(C))
    local_correlation_bwd.launches += 1
    return dfm1, dfm2


local_correlation_bwd.launches = 0


class LocalCorrelation(torch.autograd.Function):
    """Differentiable local correlation: the forward of ``route`` (a key of
    :data:`FORWARDS`), :func:`local_correlation_bwd` backward (the
    ``custom_vjp`` of ``pallas_correlation_trainable(forward=...)``, whose
    backward is the same for every forward). Episodes folded into the batch
    axis make one launch each way per call."""

    @staticmethod
    def forward(ctx, fm1, fm2, r: int, route: str = "select"):
        ctx.save_for_backward(fm1, fm2)
        ctx.r = r
        return FORWARDS[route](fm1, fm2, r)

    @staticmethod
    def backward(ctx, g):
        fm1, fm2 = ctx.saved_tensors
        dfm1, dfm2 = local_correlation_bwd(g, fm1, fm2, ctx.r)
        return dfm1, dfm2, None, None


def local_correlation_trainable(fm1: torch.Tensor, fm2: torch.Tensor,
                                r: int, route: str = "select") -> torch.Tensor:
    """The forward of ``route`` with the kernel backward under autograd."""
    return LocalCorrelation.apply(fm1, fm2, r, route)
