"""The t-digest merge kernels of the flush: host wrappers, gate, launch
counters, and the plain PyTorch version of each kernel.

    K1  drain_quantile      replaces veneur_tpu/ops/tdigest_pallas.py
                            _drain_quantile_slab (pl.pallas_call at :334)
    K2  compress_presorted  replaces _compress_presorted_slab (:419)
    K3  sort_b=True on K1 or K2: the b half in any order, sorted inside
                            the kernel (_bitonic_sort_desc :97)

All three live in ``csrc/tdigest_merge.cu``, built by nvcc for ``sm_90a``
into a shared library with a plain C interface (``cuda_build``) and
launched through ctypes on PyTorch's current stream. Per row they
bitonic-merge the ascending digest half with the reversed temp half,
take the log-step prefix sum of the weights, bin by the k-scale with the
Abramowitz-Stegun asin polynomial, reduce weight and weight*mean into
the output bins and gap-fill the dead bins' means with a running max;
K1 then runs the inverse-CDF for every requested quantile on the fresh
bins. The kernel reads the b half at its own width and row stride and
pads, reverses (or, with ``sort_b``, sorts) it in registers, so a call
is input checks, ``torch.empty`` outputs and one launch. Merge widths
16 and 32 run a group of ``half / 2`` lanes a row (the narrow path), 64
to 256 a warp a row, and wider ones (up to ``_MAX_MERGE_WIDTH``),
narrower ones and ``out_size > half`` a block a row (the general path):
:func:`kernel_path` names the path a shape takes.

The gate is the tensor's device: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version (``*_plain`` below), anything else raises.
There is no fallback from the kernel: a build or launch error
propagates. Each wrapper counts its kernel launches in ``.launches``
(presorted b half) and ``.sort_b_launches`` (K3); of those, the ones
that took the narrow path also count in ``.narrow16_launches`` or
``.narrow32_launches`` (by merge width) and those that took the general
path in ``.general_launches``.

The plain versions keep the JAX package's padding contract as separate
passes: the b half is padded with +inf to ``half = next_pow2(max(Ka,
Kb))`` and reversed (or sorted descending), and the output means are
gap-filled with ``torch.cummax``. The 128-row block padding and the
1M-row slab split of the Pallas wrappers exist only for Mosaic's tiling
and 32-bit operand offsets; the CUDA kernels index rows with 64-bit
offsets instead.
"""

from __future__ import annotations

import ctypes
import math

import torch

_INF = float("inf")
# widest merge the general path takes: its shared memory holds 8 L + 6 K
# floats, 224 KB at L = 4096 with K = L (the card allows 227 KB a block)
_MAX_MERGE_WIDTH = 4096


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def kernel_path(half: int, out_size: int) -> str:
    """The device path ``launch_rows`` (csrc) takes for halves padded to
    ``half`` merged into ``out_size`` bins: "narrow" (half 8 or 16),
    "warp" (half 32 to 128) or "general"."""
    if out_size <= half:
        if half in (8, 16):
            return "narrow"
        if 32 <= half <= 128:
            return "warp"
    return "general"


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """The gate: True for CUDA tensors, False for CPU tensors; mixed or
    other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"t-digest merge kernels take all-CUDA or all-CPU "
                     f"tensors, got devices {sorted(kinds)}")


def _bitonic_sort_desc_plain(key: torch.Tensor, w: torch.Tensor):
    """_bitonic_sort_desc step for step: a full bitonic sort of each row
    DESCENDING (length a power of two), weights following, so +inf
    empties land in front. Stage (k, j) pairs slot p with p + j inside
    each 2j-block and keeps the min of the signed key -key (block
    descending) where p & k == 0, of +key (ascending) elsewhere; ties
    never swap."""
    rows, l = key.shape
    pos = torch.arange(l, device=key.device)
    k = 2
    while k <= l:
        sign = torch.where((pos & k) == 0, -1.0, 1.0).to(key.dtype)
        j = k // 2
        while j >= 1:
            sk = (sign * key).view(rows, l // (2 * j), 2, j)
            k4 = key.view(rows, l // (2 * j), 2, j)
            w4 = w.view(rows, l // (2 * j), 2, j)
            swap = sk[:, :, 0] > sk[:, :, 1]
            key = torch.stack([torch.where(swap, k4[:, :, 1], k4[:, :, 0]),
                               torch.where(swap, k4[:, :, 0], k4[:, :, 1])],
                              2).view(rows, l)
            w = torch.stack([torch.where(swap, w4[:, :, 1], w4[:, :, 0]),
                             torch.where(swap, w4[:, :, 0], w4[:, :, 1])],
                            2).view(rows, l)
            j //= 2
        k *= 2
    return key, w


def _prepare_b(mean_b: torch.Tensor, weight_b: torch.Tensor, half: int,
               sort_b: bool = False):
    """Pad the b half to ``half`` with (+inf, 0) and reverse it (it is
    ascending) or, with ``sort_b``, sort it descending (it is in any
    order), so a + b is one bitonic sequence per row with the pads in
    front of b."""
    pad = half - mean_b.shape[1]
    if pad:
        rows = mean_b.shape[0]
        mean_b = torch.cat([mean_b, mean_b.new_full((rows, pad), _INF)], 1)
        weight_b = torch.cat([weight_b, weight_b.new_zeros((rows, pad))], 1)
    if sort_b:
        return _bitonic_sort_desc_plain(mean_b, weight_b)
    return (torch.flip(mean_b, [1]).contiguous(),
            torch.flip(weight_b, [1]).contiguous())


def _shapes(mean_a, mean_b):
    s, ka = mean_a.shape
    kb = mean_b.shape[1]
    return s, ka, next_pow2(max(ka, kb)), ka + kb


# ---------------------------------------------------------------------------
# Plain PyTorch versions: _merge_bin_reduce / _kernel_quantiles step for step
# ---------------------------------------------------------------------------


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive log-step prefix sum along dim 1 (the kernels' order)."""
    d, n = 1, x.shape[1]
    while d < n:
        x = x + torch.cat([x.new_zeros((x.shape[0], d)), x[:, :-d]], 1)
        d *= 2
    return x


def _bitonic_merge(key: torch.Tensor, w: torch.Tensor):
    """Merge a row-bitonic sequence ascending: log2(L) compare-exchange
    stages. At distance d, slot i of each 2d-block pairs with i+d; the
    pair swaps when the lead key is greater, weights following."""
    rows, l = key.shape
    d = l // 2
    while d >= 1:
        k4 = key.view(rows, l // (2 * d), 2, d)
        w4 = w.view(rows, l // (2 * d), 2, d)
        lo_k, hi_k, lo_w, hi_w = k4[:, :, 0], k4[:, :, 1], w4[:, :, 0], \
            w4[:, :, 1]
        swap = lo_k > hi_k
        key = torch.stack([torch.where(swap, hi_k, lo_k),
                           torch.where(swap, lo_k, hi_k)], 2).view(rows, l)
        w = torch.stack([torch.where(swap, hi_w, lo_w),
                         torch.where(swap, lo_w, hi_w)], 2).view(rows, l)
        d //= 2
    return key, w


def _asin_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 4.4.45 asin, |err| <= 6.8e-5; the kernels'
    polynomial, so the plain version bins exactly as they do. The square
    root is taken in float64 and rounded once, i.e. correctly rounded like
    the kernels' sqrtf: torch's float32 sqrt on the CPU was seen to round
    differently from one call to the next."""
    s = torch.sign(x)
    a = torch.abs(x)
    p = 1.5707288 + a * (-0.2121144 + a * (0.0742610 + a * -0.0187293))
    root = torch.sqrt(torch.clamp_min(1.0 - a, 0.0).double()).float()
    return s * (0.5 * math.pi - root * p)


def _merge_bin_reduce_plain(ma, wa, mb_rev, wb_rev, compression: float,
                            half: int, kout: int, m: int):
    """Merge the ascending a half with the padded, pre-reversed b half,
    assign k-scale bins, and reduce into kout bins. Returns (nm, sw) with
    dead bins carrying mean == -inf."""
    rows, ka = ma.shape
    if ka < half:
        ma = torch.cat([ma, ma.new_full((rows, half - ka), _INF)], 1)
        wa = torch.cat([wa, wa.new_zeros((rows, half - ka))], 1)
    key, w = _bitonic_merge(torch.cat([ma, mb_rev], 1),
                            torch.cat([wa, wb_rev], 1))
    key, w = key[:, :m], w[:, :m]          # +inf pads sort to the back
    live = w > 0
    m0 = torch.where(live, key, 0.0)
    incl = _prefix_sum(w)
    total = incl.amax(1, keepdim=True)
    q_mid = (incl - 0.5 * w) / torch.clamp_min(total, 1e-30)
    # a tensor divisor: CUDA turns division by a host scalar into a
    # multiply by its reciprocal, which would round unlike the kernel
    pi = torch.tensor(math.pi, dtype=torch.float32, device=ma.device)
    kq = compression * (_asin_poly(torch.clamp(2.0 * q_mid - 1.0, -1.0,
                                               1.0)) / pi + 0.5)
    cluster = torch.clamp(torch.floor(kq), 0.0, float(kout - 1)).long()
    sw = w.new_zeros((rows, kout)).scatter_add_(1, cluster, w)
    swm = w.new_zeros((rows, kout)).scatter_add_(1, cluster, w * m0)
    live_o = sw > 0
    nm = torch.where(live_o, swm / torch.where(live_o, sw, 1.0), -_INF)
    return nm, sw


def _kernel_quantiles_plain(nm, sw, mn, mx, qs, kout: int):
    """Batched inverse-CDF over the freshly reduced bins (dead bins
    mean == -inf), as tdigest.quantile/_upper_bounds compute it."""
    live = sw > 0
    masked = torch.where(live, nm, _INF)
    suffix = torch.flip(torch.cummin(torch.flip(masked, [1]), 1).values,
                        [1])
    next_m = torch.cat([suffix[:, 1:], suffix.new_full((sw.shape[0], 1),
                                                       _INF)], 1)
    live_ub = torch.where(torch.isfinite(next_m), 0.5 * (nm + next_m),
                          mx[:, None])
    ub = torch.cummax(torch.where(live, live_ub, -_INF), 1).values
    ub_prev = torch.cat([ub.new_zeros((ub.shape[0], 1)), ub[:, :-1]], 1)
    incl = _prefix_sum(sw)
    total = incl.amax(1, keepdim=True)
    excl = incl - sw
    target = qs[None, :] * total                                # [R, P]
    idx = (incl[:, None, :] < target[:, :, None]).sum(-1)
    idx = torch.clamp_max(idx, kout - 1)
    ub_i, prev_ub, w_i, excl_i = (torch.gather(a, 1, idx)
                                  for a in (ub, ub_prev, sw, excl))
    lo = mn[:, None]
    # leading gap bins carry ub == -inf; fall back to min
    lb = torch.where(idx == 0, lo, torch.maximum(prev_ub, lo))
    prop = (target - excl_i) / torch.where(w_i > 0, w_i, 1.0)
    out = lb + prop * (ub_i - lb)
    return torch.where(total > 0, out, float("nan"))


def compress_presorted_plain(mean_a, weight_a, mean_b, weight_b,
                             compression: float, out_size: int,
                             sort_b: bool = False):
    """The plain PyTorch version of K2 (K3 with ``sort_b``), with the
    padding and gap-fill as separate passes: same inputs and outputs as
    :func:`compress_presorted`."""
    _, _, half, m = _shapes(mean_a, mean_b)
    mb, wb = _prepare_b(mean_b, weight_b, half, sort_b)
    nm, sw = _merge_bin_reduce_plain(mean_a, weight_a, mb, wb, compression,
                                     half, out_size, m)
    return torch.cummax(nm, 1).values, sw


def drain_quantile_plain(mean_a, weight_a, mean_b, weight_b, mn, mx, qs,
                         compression: float, out_size: int,
                         sort_b: bool = False):
    """The plain PyTorch version of K1 (K3 with ``sort_b``), with the
    padding and gap-fill as separate passes: same inputs and outputs as
    :func:`drain_quantile`."""
    _, _, half, m = _shapes(mean_a, mean_b)
    mb, wb = _prepare_b(mean_b, weight_b, half, sort_b)
    nm, sw = _merge_bin_reduce_plain(mean_a, weight_a, mb, wb, compression,
                                     half, out_size, m)
    pcts = _kernel_quantiles_plain(nm, sw, mn, mx, qs, out_size)
    return torch.cummax(nm, 1).values, sw, pcts


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _kernel_lib():
    """The built library with its C signatures declared (built at first
    use; see cuda_build)."""
    from veneur_tpu_torch.ops import cuda_build

    lib = cuda_build.load("tdigest_merge")
    if not getattr(lib, "_vt_declared", False):
        # rows, ka, kb, the four row strides, out_size
        shape = [_LL, _I, _I, _LL, _LL, _LL, _LL, _I]
        lib.vt_drain_quantile.argtypes = (
            [_P] * 10 + shape + [_I, _I, ctypes.c_float, _P])
        lib.vt_drain_quantile.restype = _I
        lib.vt_compress_presorted.argtypes = (
            [_P] * 6 + shape + [_I, ctypes.c_float, _P])
        lib.vt_compress_presorted.restype = _I
        lib.vt_error_string.argtypes = [_I]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib.vt_last_kernel_name.argtypes = []
        lib.vt_last_kernel_name.restype = ctypes.c_char_p
        lib._vt_declared = True
    return lib


def _check_kernel_inputs(mean_a, weight_a, mean_b, weight_b, out_size, m,
                         half):
    for t in (mean_a, weight_a, mean_b, weight_b):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError("t-digest kernels take float32 [S, K] planes, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if mean_a.shape != weight_a.shape or mean_b.shape != weight_b.shape \
            or mean_a.shape[0] != mean_b.shape[0]:
        raise ValueError("mismatched t-digest plane shapes")
    if 2 * half > _MAX_MERGE_WIDTH:
        raise ValueError(f"merge width {2 * half} exceeds {_MAX_MERGE_WIDTH}")
    if not 0 < out_size <= m:
        raise ValueError(f"out_size {out_size} outside (0, {m}]")
    if mean_a.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31-1 rows in one launch")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The plane with unit inner stride (the kernels take any row
    stride); copies only a plane whose columns are strided."""
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def last_kernel_name() -> str:
    """The (mangled) name of the device function that this thread's last
    kernel launch ran, as the CUDA runtime names it ("" before any)."""
    return _kernel_lib().vt_last_kernel_name().decode()


def _raise_on(lib, err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.vt_error_string(err).decode()})")


def _plane_args(ma, wa, mb, wb):
    """(pointers, [rows, ka, kb, four row strides]) of the four planes."""
    return ([t.data_ptr() for t in (ma, wa, mb, wb)],
            [ma.shape[0], ma.shape[1], mb.shape[1],
             *(t.stride(0) for t in (ma, wa, mb, wb))])


def launch_drain_quantile(mean_a, weight_a, mean_b, weight_b, mn, mx, qs,
                          compression: float, out_size: int,
                          sort_b: bool = False):
    """Enqueue K1 (K3 with ``sort_b``) on the current stream over the
    function's own inputs; returns (mean gap-filled, weight,
    percentiles). Not counted: the wrapper counts."""
    ma, wa, mb, wb = (_rows(t) for t in (mean_a, weight_a, mean_b,
                                         weight_b))
    mn, mx, qs = (t.float().contiguous() for t in (mn, mx, qs))
    s, nq = ma.shape[0], qs.shape[0]
    om = torch.empty((s, out_size), dtype=torch.float32, device=ma.device)
    ow = torch.empty_like(om)
    pct = torch.empty((s, nq), dtype=torch.float32, device=ma.device)
    if s:
        lib = _kernel_lib()
        ptrs, shape = _plane_args(ma, wa, mb, wb)
        with torch.cuda.device(ma.device):
            stream = torch.cuda.current_stream(ma.device).cuda_stream
            err = lib.vt_drain_quantile(
                *ptrs, mn.data_ptr(), mx.data_ptr(), qs.data_ptr(),
                om.data_ptr(), ow.data_ptr(), pct.data_ptr(), *shape,
                out_size, nq, int(sort_b), float(compression), stream)
        _raise_on(lib, err, "drain_quantile")
    return om, ow, pct


# every wrapper's launch counters: by mode, then (a share of those) by path
COUNTERS = ("launches", "sort_b_launches", "narrow16_launches",
            "narrow32_launches", "general_launches")


def _count(wrapper, s: int, sort_b: bool, half: int, out_size: int):
    if not s:
        return
    names = ["sort_b_launches" if sort_b else "launches"]
    path = kernel_path(half, out_size)
    if path == "narrow":
        names.append(f"narrow{2 * half}_launches")
    elif path == "general":
        names.append("general_launches")
    for name in names:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def drain_quantile(mean_a, weight_a, mean_b, weight_b, mn, mx, qs,
                   compression: float, out_size: int, sort_b: bool = False):
    """K1: fused drain + percentiles. The a half must be row-ascending,
    the b half row-ascending with +inf empties (with ``sort_b``: any
    order, empties carrying mean +inf and weight 0), mn/mx the final [S]
    extrema and qs the [P] quantiles. Returns (mean [S, out_size]
    gap-filled, weight [S, out_size], percentiles [S, P])."""
    if not _use_kernel(mean_a, weight_a, mean_b, weight_b, mn, mx, qs):
        return drain_quantile_plain(mean_a, weight_a, mean_b, weight_b, mn,
                                    mx, qs, compression, out_size, sort_b)
    s, _, half, m = _shapes(mean_a, mean_b)
    _check_kernel_inputs(mean_a, weight_a, mean_b, weight_b, out_size, m,
                         half)
    if qs.dim() != 1 or mn.shape != (s,) or mx.shape != (s,):
        raise ValueError("drain_quantile takes [S] extrema and [P] "
                         "quantiles")
    out = launch_drain_quantile(mean_a, weight_a, mean_b, weight_b, mn, mx,
                                qs, compression, out_size, sort_b)
    _count(drain_quantile, s, sort_b, half, out_size)
    return out


def _init_counts(wrapper):
    for name in COUNTERS:
        setattr(wrapper, name, 0)


_init_counts(drain_quantile)


def launch_compress_presorted(mean_a, weight_a, mean_b, weight_b,
                              compression: float, out_size: int,
                              sort_b: bool = False):
    """Enqueue K2 (K3 with ``sort_b``) on the current stream over the
    function's own inputs; returns (mean gap-filled, weight). Not
    counted: the wrapper counts."""
    ma, wa, mb, wb = (_rows(t) for t in (mean_a, weight_a, mean_b,
                                         weight_b))
    s = ma.shape[0]
    om = torch.empty((s, out_size), dtype=torch.float32, device=ma.device)
    ow = torch.empty_like(om)
    if s:
        lib = _kernel_lib()
        ptrs, shape = _plane_args(ma, wa, mb, wb)
        with torch.cuda.device(ma.device):
            stream = torch.cuda.current_stream(ma.device).cuda_stream
            err = lib.vt_compress_presorted(
                *ptrs, om.data_ptr(), ow.data_ptr(), *shape, out_size,
                int(sort_b), float(compression), stream)
        _raise_on(lib, err, "compress_presorted")
    return om, ow


def compress_presorted(mean_a, weight_a, mean_b, weight_b,
                       compression: float, out_size: int,
                       sort_b: bool = False):
    """K2: fused compress of a row-ascending centroid list with a second
    row-ascending list (+inf empties; with ``sort_b`` any order).
    Returns (mean gap-filled, weight), each [S, out_size]."""
    if not _use_kernel(mean_a, weight_a, mean_b, weight_b):
        return compress_presorted_plain(mean_a, weight_a, mean_b, weight_b,
                                        compression, out_size, sort_b)
    s, _, half, m = _shapes(mean_a, mean_b)
    _check_kernel_inputs(mean_a, weight_a, mean_b, weight_b, out_size, m,
                         half)
    out = launch_compress_presorted(mean_a, weight_a, mean_b, weight_b,
                                    compression, out_size, sort_b)
    _count(compress_presorted, s, sort_b, half, out_size)
    return out


_init_counts(compress_presorted)
