"""Fused GEMMs: norm prologue -> A @ B -> epilogue, plain and gated.

`fused_matmul` replaces the TPU kernel `src/repro/kernels/matmul.py:matmul`
(`_fused_mm_kernel`); its CUDA source is `csrc/fused_matmul.cu`.
`matmul_swiglu` replaces `matmul.py:matmul_swiglu` (`_fused_gated_kernel`):
silu(norm(A) @ Bg) * (norm(A) @ Bu) + residual in one pass, CUDA source
`csrc/fused_swiglu.cu`.  Both sources share the templates of `csrc/gemm.cuh`;
`gemm_plan` picks one per call:

  ``stream``  bf16 or int8 weights, M <= 8 (decode): a weight stream on CUDA
              cores in exact fp32, K split across blocks, the splits'
              partials added in split order by a second kernel before the
              norm is applied;
  ``wgmma``   bf16 A, bf16 or int8 weights, M > 8 (prefill): TMA and tensor
              cores (int8 tiles widened to bf16 in shared memory, exact);
              x * gamma is rounded once to bf16 for a bf16 output, split into
              bf16 hi + lo (two products) for an fp32 output;
  ``fma32``   fp32 weights (an fp32 policy in `auto` mode): the first design's
              fp32 FMA loop.

Int8 weights (`models/quantize.py`) come with one fp32 scale per output
column (`b_scale`; the gated kernel: `bg_scale`, `bu_scale`), applied to
the fp32 accumulator after the norm's finalize and before the bias, the
activation (or silu(g) * u) and the residual: the TPU kernel's order
(`src/repro/kernels/matmul.py:_fused_mm_kernel`).  The unfused reference
(`ref.fused_matmul_ref`) rounds the dot to the output dtype before it
scales; the kernels scale the fp32 accumulator and round once.

`matmul_plain` is the function's definition in plain PyTorch: fp32
operands (the prologue scales A by gamma in fp32 and the weight is upcast),
fp32 accumulation, the deferred RMSNorm / LayerNorm finalize, fp32
epilogue, one cast at the store; `matmul_swiglu_plain` does the same for
both gated products, then silu(g) * u in fp32.  The stream and fma32
templates differ from it by the order of fp32 sums only; the wgmma template
also by where it rounds x * gamma (above).  `gemm_emulate` repeats each
template's arithmetic (split ranges and their order, the bf16 roundings) in
plain PyTorch for the tests.  `matmul_plain` differs from
`ref.fused_matmul_ref` — which normalizes first and casts to the compute
dtype before the dot — by bf16 rounding only.  The wrappers launch a kernel
for CUDA tensors and take the plain version for CPU tensors; they never
fall back from one to the other, and raise on operands no template takes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.activations import get_activation
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import RMS_EPS

_NORM = {"none": 0, "rmsnorm": 1, "layernorm": 2}
_ACT = {"none": 0, "gelu": 1, "gelu_exact": 2, "i_gelu": 3, "silu": 4}
_TEMPLATES = {"fma32": 0, "stream": 1, "wgmma": 2}    # gemm.cuh TemplateCode
# the wrappers' launch counts by template and weight form
FORMS = ("fma32", "stream", "wgmma", "stream_int8", "wgmma_int8")
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 10 + [ctypes.c_float] + [_I] * 5 + [_P]
_SWIGLU_ARGTYPES = [_P] * 10 + [_I] * 9 + [ctypes.c_float] + [_I] * 5 + [_P]

SM_COUNT = 132              # H100 SXM
STREAM_MAX_M = 8            # gemm.cuh STREAM_MAX_M
STREAM_COLS = 256           # output columns of one stream block
STREAM_BLOCKS_PER_SM = 3    # resident stream blocks per SM when not queried
STREAM_MIN_CHUNK = 32       # K rows of one split, at least
STREAM_STAGE_BYTES = 32 * 1024   # staged rows of one split: (M + 2) fp32 each
STREAM_MAX_WAVES = 8        # grids of up to this many waves are considered
WG_TILE = (128, 256, 64)    # wgmma block tile (rows, B columns, K step)
WG_MIN_SPLIT_STEPS = 4      # K steps of one wgmma split, at least


@dataclass(frozen=True)
class GemmPlan:
    """How one fused GEMM call runs: the template, its tile, the K rows of
    one split (`kchunk`), the number of splits and the launch grid."""
    template: str
    tile: Tuple[int, ...]
    kchunk: int
    splits: int
    grid: Tuple[int, ...]

    def k_ranges(self, K: int):
        """The K rows [k0, k1) of each split, in split order."""
        return [(z * self.kchunk, min(K, (z + 1) * self.kchunk))
                for z in range(self.splits)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def gemm_plan(M: int, K: int, N: int, *, w_dtype=torch.bfloat16,
              gated: bool = False, sm_count: int = SM_COUNT,
              blocks_per_sm: int = STREAM_BLOCKS_PER_SM,
              kchunk: Optional[int] = None) -> GemmPlan:
    """The plan of an [M, K] @ [K, N] fused GEMM (gated: N output columns of
    each of two weights).  Stream template: the K split is chosen so that
    the grid fills whole waves of `sm_count * blocks_per_sm` resident
    blocks, the fewest waves that reach 90%; `kchunk` overrides it (tests).
    Raises on bf16 and int8 shapes no template takes: the wgmma template
    reads int8 rows by TMA, which needs N % 16 == 0 (16-byte rows)."""
    if w_dtype == torch.float32:
        tile = ((16, 16 if gated else 32, 128) if M <= 16
                else (64, 32 if gated else 64, 16))
        return GemmPlan("fma32", tile, K, 1,
                        (_cdiv(N, tile[1]), _cdiv(M, tile[0])))
    if w_dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"fused GEMM: weights must be bfloat16, int8 or "
                        f"float32, not {w_dtype}")
    if M < 1 or N % 8 or K % 8:
        raise ValueError(f"fused GEMM: a {w_dtype} [{M}, {K}] @ [{K}, {N}] "
                         f"needs M >= 1 and N, K multiples of 8")
    if w_dtype == torch.int8 and M > STREAM_MAX_M and N % 16:
        raise ValueError(f"fused GEMM: the wgmma template reads int8 rows "
                         f"of N % 16 == 0 bytes, not N = {N}")
    if M <= STREAM_MAX_M:
        mt = next(t for t in (1, 2, 4, 8) if M <= t)
        strips = _cdiv(N, STREAM_COLS)
        if kchunk is None:
            kchunk = _stream_chunk(K, strips, mt, sm_count, blocks_per_sm)
        splits = _cdiv(K, kchunk)
        return GemmPlan("stream", (mt, STREAM_COLS), kchunk, splits,
                        (strips, splits))
    bm, bn, bk = WG_TILE
    if gated:
        bn //= 2
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    ktiles = _cdiv(K, bk)
    if kchunk is None:
        # too few tiles to fill the card: split K, each split at least
        # WG_MIN_SPLIT_STEPS K steps, in one wave of one block per SM
        want = 1
        if tiles < sm_count:
            want = max(1, min(sm_count // tiles, ktiles // WG_MIN_SPLIT_STEPS))
        kchunk = _cdiv(ktiles, want) * bk
    kchunk = _cdiv(kchunk, bk) * bk
    splits = _cdiv(K, kchunk)
    return GemmPlan("wgmma", (bm, bn, bk), kchunk, splits,
                    (_cdiv(M, bm), _cdiv(N, bn), splits))


def _stream_chunk(K: int, strips: int, mt: int, sm_count: int,
                  blocks_per_sm: int) -> int:
    """K rows of one split: a multiple of 8 in [STREAM_MIN_CHUNK, the
    staging cap] whose grid (strips x splits) holds at least two blocks per
    SM and fills waves of sm_count x blocks_per_sm resident blocks best: the
    fewest waves that reach 90%, else the best fill."""
    cap = STREAM_STAGE_BYTES // (4 * (mt + 2)) // 8 * 8
    slots = sm_count * blocks_per_sm
    best = None
    for waves in range(1, STREAM_MAX_WAVES + 1):
        want = max(1, round(waves * slots / strips))
        chunk = min(max(_cdiv(_cdiv(K, want), 8) * 8, STREAM_MIN_CHUNK), cap)
        blocks = strips * _cdiv(K, chunk)
        fill = blocks / (_cdiv(blocks, slots) * slots)
        score = (blocks >= 2 * sm_count, fill)
        if best is None or score > best[0]:
            best = (score, chunk)
        if score >= (True, 0.9):
            return chunk
    return best[1]


def _part_numel(plan: GemmPlan, M: int, N: int, nb: int) -> int:
    """fp32 scratch of a split stream GEMM: acc [S, nb, M, N], gamma@W and
    beta@W [S, nb, 2, N], row sums [S, M, 2] (gemm.cuh stream_kernel)."""
    S = plan.splits
    return S * nb * M * N + S * nb * 2 * N + S * M * 2


def _normed_product(a, b, norm, gamma, nbeta, eps, scale=None):
    """norm(A) @ B in fp32: A scaled by gamma in fp32, the weight upcast,
    the norm statistics applied after the product; an int8 weight's column
    scale after them."""
    af, bf = a.float(), b.float()
    K = a.shape[-1]
    if norm == "none":
        y = af @ bf
    else:
        g = gamma.float()
        y = (af * g) @ bf
        s2 = (af * af).sum(-1, keepdim=True)
        if norm == "rmsnorm":
            y = y * torch.rsqrt(s2 / K + eps)
        else:
            mu = af.sum(-1, keepdim=True) / K
            var = s2 / K - mu * mu
            y = (y - mu * (g @ bf)) * torch.rsqrt(var + eps)
            y = y + nbeta.float() @ bf
    if scale is not None:
        y = y * scale.float()
    return y


def _out_dtype(a, residual, out_dtype):
    return out_dtype or (residual.dtype if residual is not None else a.dtype)


def _epilogue(ys, bias, residual, activation, out_dtype):
    """bias + activation (one product) or silu(g) * u (two), then the
    residual and one cast."""
    if len(ys) == 2:
        y = torch.nn.functional.silu(ys[0]) * ys[1]
    else:
        y = ys[0]
        if bias is not None:
            y = y + bias.float()
        if activation != "none":
            y = get_activation(activation)(y)
    if residual is not None:
        y = y + residual.float().reshape(y.shape)
    return y.to(out_dtype)


def matmul_plain(a, b, *, norm="none", gamma=None, nbeta=None, bias=None,
                 residual=None, activation="none", eps=RMS_EPS,
                 out_dtype=None, b_scale=None):
    """act(norm(A) @ B * b_scale + bias) + residual in fp32.  A: [M, K],
    B: [K, N] (int8 with its [N] `b_scale`, or bf16 / fp32)."""
    out_dtype = _out_dtype(a, residual, out_dtype)
    y = _normed_product(a, b, norm, gamma, nbeta, eps, b_scale)
    return _epilogue([y], bias, residual, activation, out_dtype)


def gemm_emulate(a, b, b_up=None, *, plan: GemmPlan, norm="none", gamma=None,
                 nbeta=None, bias=None, residual=None, activation="none",
                 eps=RMS_EPS, out_dtype=None, scales=None):
    """A template's arithmetic in plain PyTorch (tests only): `plan`'s K
    ranges each give fp32 partials of x*gamma @ W, sum x, sum x^2, gamma @ W
    and beta @ W, added in split order before the norm is applied once; the
    wgmma template rounds x * gamma to bf16 (bf16 output) or splits it into
    bf16 hi + lo (fp32 output).  `b_up`: the gated kernel, silu(g) * u.
    `scales`: int8 weights' column scales (one a weight), applied after
    the norm."""
    out_dtype = _out_dtype(a, residual, out_dtype)
    af = a.float()
    K = a.shape[1]
    ws = [w.float() for w in ((b,) if b_up is None else (b, b_up))]
    g = gamma.float() if norm != "none" else af.new_ones(K)
    bt = nbeta.float() if norm == "layernorm" else af.new_zeros(K)
    terms = None                      # stream / fma32: x * gamma in fp32
    if plan.template == "wgmma":
        if a.dtype != torch.bfloat16:
            raise ValueError("the wgmma template takes a bf16 A")
        v = af * g
        terms = [v]
        if norm != "none":
            hi = v.bfloat16().float()
            terms = [hi]
            if out_dtype == torch.float32:
                terms.append((v - hi).bfloat16().float())
    M = a.shape[0]
    s1 = s2 = af.new_zeros(M, 1)
    accs = [af.new_zeros(M, w.shape[1]) for w in ws]
    gws = [af.new_zeros(w.shape[1]) for w in ws]
    bws = [af.new_zeros(w.shape[1]) for w in ws]
    for k0, k1 in plan.k_ranges(K):
        x = af[:, k0:k1]
        s1 = s1 + x.sum(-1, keepdim=True)
        s2 = s2 + (x * x).sum(-1, keepdim=True)
        for i, w in enumerate(ws):
            wk = w[k0:k1]
            if terms is None:
                accs[i] = accs[i] + (x * g[k0:k1]) @ wk
            else:
                for t in terms:
                    accs[i] = accs[i] + t[:, k0:k1] @ wk
            gws[i] = gws[i] + g[k0:k1] @ wk
            bws[i] = bws[i] + bt[k0:k1] @ wk
    ys = []
    for i, (acc, gw, bw) in enumerate(zip(accs, gws, bws)):
        if norm == "rmsnorm":
            acc = acc * torch.rsqrt(s2 / K + eps)
        elif norm == "layernorm":
            mu = s1 / K
            rstd = torch.rsqrt(s2 / K - mu * mu + eps)
            acc = (acc - mu * gw) * rstd + bw
        if scales is not None:
            acc = acc * scales[i].float()
        ys.append(acc)
    return _epilogue(ys, bias, residual, activation, out_dtype)


def _count(wrapper, plan: GemmPlan, int8: bool) -> None:
    wrapper.launches += 1
    wrapper.launches_by[plan.template + ("_int8" if int8 else "")] += 1


_OCCUPANCY = {}


def _stream_slots(device, M, gated, int8):
    """(SMs, resident stream blocks per SM) of the card at M rows, queried
    from the built kernel (of bf16 or int8 weights) once."""
    mt = next(t for t in (1, 2, 4, 8) if M <= t)
    key = (device.index, mt, gated, int8)
    if key not in _OCCUPANCY:
        lib, sym = (("fused_swiglu", "repro_fused_swiglu_stream_occupancy")
                    if gated else
                    ("fused_matmul", "repro_fused_matmul_stream_occupancy"))
        blocks = build.bind(lib, sym, [_I, _I])(mt, int(int8))
        if blocks < 1:
            raise RuntimeError(f"{lib}: stream occupancy query failed "
                               f"({blocks})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _OCCUPANCY[key] = (sms, blocks)
    return _OCCUPANCY[key]


def _launch_operands(what, a, weights, vecs, residual, M, N, out_dtype,
                     gated, scales=None):
    """Plan, check and lay out one launch: (plan, a, weights, scales, vecs,
    residual, out, part).  `scales`: the int8 weights' [N] fp32 column
    scales (None for bf16 / fp32 weights)."""
    K = a.shape[1]
    int8 = weights[0].dtype == torch.int8
    if int8 != (scales is not None) or (int8 and any(
            s is None or s.shape != (N,) for s in scales)):
        raise ValueError(f"{what}: int8 weights take an [{N}] scale each, "
                         f"other weights none")
    slots = {}
    if weights[0].dtype in (torch.bfloat16, torch.int8) and \
            M <= STREAM_MAX_M:
        sms, blocks = _stream_slots(a.device, M, gated, int8)
        slots = dict(sm_count=sms, blocks_per_sm=blocks)
    plan = gemm_plan(M, K, N, w_dtype=weights[0].dtype, gated=gated, **slots)
    if plan.template == "wgmma" and a.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the wgmma template (M > {STREAM_MAX_M}) "
                         f"takes a bf16 A with bf16 weights, got {a.dtype}")
    if plan.template != "fma32" and any(w.dtype != weights[0].dtype
                                        for w in weights):
        raise ValueError(f"{what}: the weights' dtypes differ")
    # TMA and 16-byte weight loads want 16-byte aligned rows: an activation
    # view at an odd offset gets a fresh (aligned) copy
    a = a.contiguous()
    if plan.template != "fma32" and not build.aligned16(a):
        a = a.clone()
    weights = [w.contiguous() for w in weights]
    if plan.template != "fma32" and not build.aligned16(*weights):
        raise ValueError(f"{what}: weights must be 16-byte aligned")
    if int8:
        scales = [s.float().contiguous() for s in scales]
    vec_dtype = next((v.dtype for v in vecs if v is not None), torch.float32)
    vecs = [None if v is None else v.to(vec_dtype).contiguous()
            for v in vecs]
    if plan.template == "wgmma":        # gamma / beta are read by TMA too
        vecs = [v if v is None or build.aligned16(v) else v.clone()
                for v in vecs]
    if residual is not None:
        residual = residual.reshape(M, N).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    part = None
    if plan.splits > 1:
        part = torch.empty(_part_numel(plan, M, N, 2 if gated else 1),
                           dtype=torch.float32, device=a.device)
    return plan, a, weights, scales, vecs, residual, out, part


def fused_matmul(a, b, *, norm="none", gamma=None, nbeta=None, bias=None,
                 residual=None, activation="none", eps=RMS_EPS,
                 out_dtype=None, b_scale=None):
    """The fused GEMM.  A: [M, K], B: [K, N] -> [M, N] at `out_dtype`
    (default: the residual's dtype, else A's).  An int8 B takes its [N]
    fp32 column scale `b_scale`."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, norm=norm, gamma=gamma, nbeta=nbeta,
                            bias=bias, residual=residual,
                            activation=activation, eps=eps,
                            out_dtype=out_dtype, b_scale=b_scale)
    out_dtype = _out_dtype(a, residual, out_dtype)
    build.require_cuda("fused_matmul", a, b, gamma, nbeta, bias, residual,
                       b_scale)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fused_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    plan, a, (b,), scales, (gamma, nbeta, bias), residual, out, part = \
        _launch_operands("fused_matmul", a, [b], [gamma, nbeta, bias],
                         residual, M, N, out_dtype, gated=False,
                         scales=None if b_scale is None else [b_scale])
    scale = scales[0] if scales else None
    vec = next((v for v in (gamma, nbeta, bias) if v is not None), None)
    fn = build.bind("fused_matmul", "repro_fused_matmul", _ARGTYPES)
    err = fn(*map(build.ptr, (a, b, scale, gamma, nbeta, bias, residual, out,
                              part)), M, N, K,
             build.dtype_code(a), build.dtype_code(b),
             build.dtype_code(vec) if vec is not None else 0,
             build.dtype_code(residual) if residual is not None else 0,
             build.dtype_code(out), _NORM[norm], _ACT[activation], float(eps),
             int(K % 4 == 0 and build.aligned16(a)),
             int(N % 4 == 0 and build.aligned16(b)),
             _TEMPLATES[plan.template], plan.kchunk, plan.splits,
             build.stream_of(a))
    build.check(err, f"fused_matmul launch ({plan.template})")
    _count(fused_matmul, plan, scale is not None)
    return out


fused_matmul.launches = 0
fused_matmul.launches_by = dict.fromkeys(FORMS, 0)


def matmul_swiglu_plain(a, b_gate, b_up, *, norm="none", gamma=None,
                        nbeta=None, residual=None, eps=RMS_EPS,
                        out_dtype=None, bg_scale=None, bu_scale=None):
    """silu(norm(A) @ Bg * bg_scale) * (norm(A) @ Bu * bu_scale) + residual
    in fp32.  A: [M, K]; Bg, Bu: [K, N] (int8 with their scales, or bf16 /
    fp32)."""
    out_dtype = _out_dtype(a, residual, out_dtype)
    g = _normed_product(a, b_gate, norm, gamma, nbeta, eps, bg_scale)
    u = _normed_product(a, b_up, norm, gamma, nbeta, eps, bu_scale)
    return _epilogue([g, u], None, residual, "none", out_dtype)


def _check_swiglu(a, b_gate, b_up, norm, gamma, nbeta, residual):
    """Raise on operands the gated kernel does not take."""
    build.require_cuda("matmul_swiglu", a, b_gate, b_up, gamma, nbeta,
                       residual)
    ok = (a.ndim == 2 and b_gate.ndim == 2 and b_gate.shape == b_up.shape
          and a.shape[1] == b_gate.shape[0] and b_gate.dtype == b_up.dtype
          and norm in _NORM and (norm == "none" or gamma is not None)
          and (norm != "layernorm" or nbeta is not None))
    if not ok:
        raise ValueError(f"matmul_swiglu: unsupported operands "
                         f"{tuple(a.shape)} @ {tuple(b_gate.shape)} / "
                         f"{tuple(b_up.shape)}, norm {norm!r}")
    if residual is not None and residual.numel() != a.shape[0] * \
            b_gate.shape[1]:
        raise ValueError(f"matmul_swiglu: residual {tuple(residual.shape)} "
                         f"does not match the output")


def matmul_swiglu(a, b_gate, b_up, *, norm="none", gamma=None, nbeta=None,
                  residual=None, eps=RMS_EPS, out_dtype=None, bg_scale=None,
                  bu_scale=None):
    """The fused gated GEMM.  A: [M, K]; Bg, Bu: [K, N] -> [M, N] at
    `out_dtype` (default: the residual's dtype, else A's).  Int8 Bg / Bu
    take their [N] fp32 column scales `bg_scale` / `bu_scale`."""
    if a.device.type == "cpu":
        return matmul_swiglu_plain(a, b_gate, b_up, norm=norm, gamma=gamma,
                                   nbeta=nbeta, residual=residual, eps=eps,
                                   out_dtype=out_dtype, bg_scale=bg_scale,
                                   bu_scale=bu_scale)
    out_dtype = _out_dtype(a, residual, out_dtype)
    _check_swiglu(a, b_gate, b_up, norm, gamma, nbeta, residual)
    if (bg_scale is None) != (bu_scale is None):
        raise ValueError("matmul_swiglu: both int8 weights take a scale")
    build.require_cuda("matmul_swiglu", a, bg_scale, bu_scale)
    M, K = a.shape
    N = b_gate.shape[1]
    plan, a, (b_gate, b_up), scales, (gamma, nbeta), residual, out, part = \
        _launch_operands("matmul_swiglu", a, [b_gate, b_up], [gamma, nbeta],
                         residual, M, N, out_dtype, gated=True,
                         scales=None if bg_scale is None
                         else [bg_scale, bu_scale])
    sg, su = scales if scales else (None, None)
    fn = build.bind("fused_swiglu", "repro_fused_swiglu", _SWIGLU_ARGTYPES)
    err = fn(*map(build.ptr, (a, b_gate, b_up, sg, su, gamma, nbeta, residual,
                              out, part)), M, N, K,
             build.dtype_code(a), build.dtype_code(b_gate),
             build.dtype_code(gamma) if gamma is not None else 0,
             build.dtype_code(residual) if residual is not None else 0,
             build.dtype_code(out), _NORM[norm], float(eps),
             int(K % 4 == 0 and build.aligned16(a)),
             int(N % 4 == 0 and build.aligned16(b_gate, b_up)),
             _TEMPLATES[plan.template], plan.kchunk, plan.splits,
             build.stream_of(a))
    build.check(err, f"matmul_swiglu launch ({plan.template})")
    _count(matmul_swiglu, plan, sg is not None)
    return out


matmul_swiglu.launches = 0
matmul_swiglu.launches_by = dict.fromkeys(FORMS, 0)
