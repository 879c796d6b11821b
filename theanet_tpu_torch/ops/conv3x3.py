"""3x3 stride-1 valid convolution with a hand-written forward and backward.

Port of ``theanet_tpu/ops/conv_pallas.py``: ``_fwd_kernel`` and
``_bwd_kernel`` become the forward and backward of ``csrc/conv3x3.cu``,
and ``jax.custom_vjp`` becomes ``torch.autograd.Function``. The function
is a CORRELATION (the caller flips the filter for a true convolution):
x (B, C, H, H), w (M, C, 3, 3) -> (B, M, H-2, H-2), in f32 or bf16 with
f32 accumulation.

  * ``eligible`` is the JAX package's predicate, unchanged, so the same
    environment routes the same convs in both packages.
  * ``conv3x3_forward_reference`` / ``conv3x3_backward_reference`` are the
    plain PyTorch versions: the specification the kernels are held to, and
    what CPU tensors run. They sum tap by tap in the JAX kernel's order
    (taps outer, k = dy*3 + dx, each a K = C or K = M product) in f32.
  * ``conv3x3_forward`` / ``conv3x3_backward`` are the wrappers: CPU
    tensors run the plain version, CUDA tensors launch the kernel (counted
    in ``conv3x3_forward.launches`` and ``conv3x3_backward.launches``), any
    other device raises.
  * ``conv3x3_valid`` is the differentiable function.
  * ``conv3x3_plan`` is the kernels' tiling: strips, map tiles, dw slices,
    channel padding and shared bytes, a pure function of the shapes. The
    wrappers pass it to the C entries, which check it against their own
    needs, so the CPU tests pin what the card runs.

The TPU kernel's lane roll, padded H*W lane grid, crop, valid mask and
VMEM batch accumulator are Mosaic workarounds: the kernels here compute
the valid outputs directly, and sum dw over the batch in a fixed order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["eligible", "conv3x3_forward_reference",
           "conv3x3_backward_reference", "conv3x3_forward",
           "conv3x3_backward", "conv3x3_valid", "conv3x3_plan",
           "Conv3x3Plan"]

F = 3  # filter side this kernel specializes
_DTYPES = (torch.float32, torch.bfloat16)

# The tiling constants of csrc/conv3x3.cu (its enum of the same names).
THREADS = 256
BM = 128             # output pixels of a dw strip, and of a conv tile but
                     # at 64 output channels (256 there: _conv_bm)
CHUNK = 128          # bytes of channels staged per pixel at a time
PITCH = CHUNK + 16   # bytes between staged pixels (16 more: no bank conflicts)
KSTEP = 32           # bytes of depth per MMA step: 16 bf16 or 8 f32
KSPAN = 2 * KSTEP    # bytes of depth a partial sums; channels pad to it
WG_M, WG_C = 64, 32  # a dw tile: maps x channels, all 9 taps
# the dw stages' pitches in bytes (dz rows of WG_M maps, x rows of WG_C
# channels), by element size
WG_PITCH = {2: (144, 80), 4: (288, 160)}
# dw is summed in slices of whole strips, each slice at most this many
# terms deep, then over the slices in order: f32 sums over a whole batch
# come near the f32 bound (PERF.md)
DW_DEPTH = 4096
SMS = 132             # the H100's streaming multiprocessors
SM_SHARED = 233472    # shared bytes of an SM, 1024 of them kept per block
SMEM_OPT_IN = 232448  # dynamic shared bytes a block may opt in to
GRID_YZ = 65535       # CUDA's limit on gridDim.y and gridDim.z


def eligible(x_shape, w_shape, mode, stride):
    """Shapes the kernel takes (conv_pallas.py:41-51): 3x3, stride 1,
    valid, square, C % 8 == 0, C >= 16, M % 8 == 0."""
    B, C, H, W = x_shape
    M, C2, fh, fw = w_shape
    return (
        mode == "valid" and stride == 1
        and fh == F and fw == F and C2 == C and H == W
        and C % 8 == 0 and C >= 16 and M % 8 == 0
        and H >= F
    )


# the taps in the kernel's order, k = dy * 3 + dx
_TAPS = [(dy, dx) for dy in range(F) for dx in range(F)]


def conv3x3_forward_reference(x, w):
    """z (B, M, H-2, H-2) in x's dtype: for each tap in order, z += the
    K = C product w[:, :, dy, dx] . x[:, :, dy:dy+O, dx:dx+O], in f32."""
    O = x.shape[2] - F + 1
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    z = None
    for dy, dx in _TAPS:
        t = torch.einsum("mc,bcyx->bmyx", wf[:, :, dy, dx],
                         xf[:, :, dy:dy + O, dx:dx + O])
        z = t if z is None else z + t
    return z.to(x.dtype)


def conv3x3_backward_reference(x, w, dz):
    """(dx, dw) of conv3x3_forward_reference for dz (B, M, O, O): dx in
    x's dtype, the full correlation of dz with the flipped taps summed tap
    by tap (K = M each) in f32; dw (M, C, 3, 3) summed over the whole batch
    in f32, then cast to w's dtype (conv_pallas.py:229-244)."""
    O = x.shape[2] - F + 1
    xf, wf, dzf = x.to(torch.float32), w.to(torch.float32), dz.to(
        torch.float32)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    for dy, dxo in _TAPS:
        dx[:, :, dy:dy + O, dxo:dxo + O] += torch.einsum(
            "mc,bmyx->bcyx", wf[:, :, dy, dxo], dzf)
        dw[:, :, dy, dxo] = torch.einsum(
            "bmyx,bcyx->mc", dzf, xf[:, :, dy:dy + O, dxo:dxo + O])
    return dx.to(x.dtype), dw.to(w.dtype)


def _ceil(a, b):
    return -(-a // b)


class Strips(NamedTuple):
    """Output tiles of ``rows`` x ``cols`` pixels covering an ``out`` x
    ``out`` map: whole rows of one image while a row fits the tile's
    pixels, else pieces of one row; ``strips_c`` across, ``strips`` in
    all."""
    out: int
    rows: int
    cols: int
    strips_c: int
    strips: int

    def tiles(self):
        """(oy0, ox0, rows, cols) of each strip, in blockIdx.x order, as
        the kernels decode it."""
        for s in range(self.strips):
            sr, sc = divmod(s, self.strips_c)
            oy0, ox0 = sr * self.rows, sc * self.cols
            yield (oy0, ox0, min(self.rows, self.out - oy0),
                   min(self.cols, self.out - ox0))


def _strips(out, pixels):
    rows, cols = (min(out, pixels // out), out) if out <= pixels else (
        1, pixels)
    strips_c = _ceil(out, cols)
    return Strips(out, rows, cols, strips_c, _ceil(out, rows) * strips_c)


def _conv_bn(N):
    """Output channels of a conv tile: the least of 32, 64, 128 that holds
    N, else 128."""
    return 32 if N <= 32 else 64 if N <= 64 else 128


def _conv_bm(bn):
    """Output pixels of a conv tile (the kernel's conv_bm): 8 warps of 32
    pixels x 64 channels at BN 64, of 32 pixels x BN / 2 otherwise."""
    return 256 if bn == 64 else BM


class ConvPass(NamedTuple):
    """One launch of the conv body (the forward, or dx as the forward of
    the zero-padded dz): its input is channel-last, ``side`` x ``side`` x
    ``kp`` (K channels padded to a multiple of KSPAN bytes), its output
    ``n`` maps of ``strips.out`` x ``strips.out`` pixels in NCHW, a tile
    ``bn`` maps of one strip."""
    side: int
    kp: int
    n: int
    np: int      # n padded to a multiple of bn (rows of the weight table)
    bn: int
    strips: Strips
    smem: int

    def grid(self, B):
        return (self.strips.strips, self.np // self.bn, B)


def _conv_pass(side, K, N, esize):
    bn = _conv_bn(N)
    st = _strips(side - F + 1, _conv_bm(bn))
    kp = _ceil(K * esize, KSPAN) * KSPAN // esize
    # two stages where there are two chunks or more and the tile is small
    stages = 2 if kp * esize > CHUNK and _conv_bm(bn) == BM else 1
    pipe = stages * (st.rows + 2) * (st.cols + 2) * PITCH + 3 * bn * PITCH
    epilogue = bn * (_conv_bm(bn) + 16 // esize) * esize
    return ConvPass(side, kp, N, _ceil(N, bn) * bn, bn, st,
                    max(pipe, epilogue))


class Conv3x3Plan(NamedTuple):
    """The kernels' tiling for x (B, C, H, H), w (M, C, 3, 3) in one dtype
    (``conv3x3_plan``)."""
    B: int
    C: int
    H: int
    M: int
    esize: int          # bytes of an element: 2 bf16, 4 f32
    fwd: ConvPass       # z from x (side H, C -> M)
    dgrad: ConvPass     # dx from dz zero-padded by 2 (side H + 2, M -> C)
    dw: Strips          # dw's strips of at most BM output pixels
    per_slice: int      # dw: strips (units) a slice sums
    slices: int
    cq: int             # channel stride of the dw slices (C to WG_C)
    wg_smem: int

    @property
    def units(self):
        return self.B * self.dw.strips

    def wg_grid(self):
        return (self.slices, _ceil(self.C, WG_C), _ceil(self.M, WG_M))

    def slice_units(self):
        """[first, end) of the (image, strip) units of each dw slice, in
        order; unit u is image u // strips, strip u % strips."""
        for s in range(self.slices):
            yield s * self.per_slice, min(self.units,
                                          (s + 1) * self.per_slice)

    def ints(self):
        """The integers the C entries take, in csrc/conv3x3.cu's order."""
        f, d = self.fwd, self.dgrad
        return [f.kp, f.np, f.bn, f.strips.rows, f.strips.cols, f.smem,
                d.kp, d.np, d.bn, d.strips.rows, d.strips.cols, d.smem,
                self.dw.rows, self.dw.cols, self.per_slice, self.slices,
                self.cq, self.wg_smem]

    def scratch(self):
        """{name: (shape, dtype)} of the wrappers' scratch tensors: the
        weight tables of the two conv passes, the channel-last x, the
        channel-last dz with its zero halo and the f32 dw slices."""
        f, d = self.fwd, self.dgrad
        return {"wt_fwd": ((9, f.np, f.kp), None),
                "wt_dgrad": ((9, d.np, d.kp), None),
                "x_cl": ((self.B, self.H, self.H, f.kp), None),
                "dz_cl": ((self.B, d.side, d.side, d.kp), None),
                "part": ((self.slices, self.M, 9, self.cq), torch.float32)}


def conv3x3_plan(B, C, H, M, dtype):
    """The tiling csrc/conv3x3.cu runs for x (B, C, H, H), w (M, C, 3, 3)
    of ``dtype`` (f32 or bf16): a pure function of the shapes.

    The forward and dx are one conv body: a block computes one strip of
    output pixels (at most 128, or 256 at 64 output channels) of one
    image for ``bn`` maps, staging the strip's input with its 2-pixel halo
    channel-last, CHUNK bytes of channels at a time (two stages where
    there are two chunks or more and the tile is 128 pixels), and the
    weights tap by tap, three tiles in a ring. dw: a block computes WG_M
    maps x WG_C channels x 9 taps over ``per_slice`` consecutive (image,
    strip) units of at most BM pixels, at most DW_DEPTH terms, as few as
    fill one wave of blocks; the slices are summed in order."""
    if dtype not in _DTYPES:
        raise ValueError(f"conv3x3_plan: dtype {dtype} is not one of "
                         f"{_DTYPES}")
    esize = 2 if dtype == torch.bfloat16 else 4
    fwd = _conv_pass(H, C, M, esize)
    dgrad = _conv_pass(H + 2, M, C, esize)
    dw = _strips(H - F + 1, BM)
    dz_pitch, x_pitch = WG_PITCH[esize]
    wg_smem = 2 * (BM * dz_pitch + (dw.rows + 2) * (dw.cols + 2) * x_pitch)
    # the fewest units a slice that still fill one wave of blocks (two an
    # SM where their shared memory fits), at most DW_DEPTH terms
    wave = SMS * (2 if 2 * (wg_smem + 1024) <= SM_SHARED else 1)
    units = B * dw.strips
    tiles = _ceil(C, WG_C) * _ceil(M, WG_M)
    per_slice = max(1, min(DW_DEPTH // (dw.rows * dw.cols),
                           _ceil(units * tiles, wave)))
    return Conv3x3Plan(B, C, H, M, esize, fwd, dgrad, dw, per_slice,
                       _ceil(units, per_slice), _ceil(C, WG_C) * WG_C,
                       wg_smem)


def _check(name, x, w, dz=None):
    """Raise unless x (B, C, H, H), w (M, C, 3, 3) and dz (B, M, O, O)
    share one dtype the kernel takes, one device, and are contiguous."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x and w must be 4-d, got {tuple(x.shape)}"
                         f" and {tuple(w.shape)}")
    B, C, H, W = x.shape
    M = w.shape[0]
    if (H != W or H < F or tuple(w.shape) != (M, C, F, F)
            or x.dtype not in _DTYPES or w.dtype != x.dtype):
        raise ValueError(f"{name}: need x (B, C, H, H) and w (M, C, 3, 3) "
                         f"of one dtype in {_DTYPES}, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(w.shape)} {w.dtype}")
    tensors = [x, w]
    if dz is not None:
        want = (B, M, H - F + 1, H - F + 1)
        if tuple(dz.shape) != want or dz.dtype != x.dtype:
            raise ValueError(f"{name}: dz must be {want} {x.dtype}, got "
                             f"{tuple(dz.shape)} {dz.dtype}")
        tensors.append(dz)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t in tensors:
        if t.device != x.device or (x.device.type == "cuda"
                                    and not t.is_contiguous()):
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             f"{x.device}")


def conv3x3_forward(x, w):
    """Same contract as conv3x3_forward_reference. A CPU ``x`` runs the
    plain version; a CUDA ``x`` launches the forward kernel on the current
    stream and counts it in ``conv3x3_forward.launches``; any other device
    raises."""
    _check("conv3x3_forward", x, w)
    if x.device.type == "cpu":
        return conv3x3_forward_reference(x, w)
    from . import _build

    B, C, H, _ = x.shape
    M, O = w.shape[0], H - F + 1
    plan = conv3x3_plan(B, C, H, M, x.dtype)
    out = torch.empty((B, M, O, O), dtype=x.dtype, device=x.device)
    _build.conv3x3_forward_launch(x, w, out, plan,
                                  **_scratch(plan, x, ("wt_fwd", "x_cl")))
    conv3x3_forward.launches += 1
    return out


def conv3x3_backward(x, w, dz):
    """Same contract as conv3x3_backward_reference; the device rule of
    conv3x3_forward, counted in ``conv3x3_backward.launches``."""
    _check("conv3x3_backward", x, w, dz)
    if x.device.type == "cpu":
        return conv3x3_backward_reference(x, w, dz)
    from . import _build

    B, C, H, _ = x.shape
    plan = conv3x3_plan(B, C, H, w.shape[0], x.dtype)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    _build.conv3x3_backward_launch(
        x, w, dz, dx, dw, plan,
        **_scratch(plan, x, ("wt_dgrad", "dz_cl", "x_cl", "part")))
    conv3x3_backward.launches += 1
    return dx, dw


def _scratch(plan, x, names):
    """The named scratch tensors of ``plan`` on x's device (x's dtype where
    the plan gives none)."""
    return {name: torch.empty(shape, dtype=dtype or x.dtype, device=x.device)
            for name, (shape, dtype) in plan.scratch().items()
            if name in names}


conv3x3_forward.launches = 0
conv3x3_backward.launches = 0


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w)

    @staticmethod
    def backward(ctx, dz):
        x, w = ctx.saved_tensors
        return conv3x3_backward(x, w, dz.contiguous())


def conv3x3_valid(x, w):
    """3x3 stride-1 valid CORRELATION (the caller handles any filter flip),
    differentiable in x and w: x (B, C, H, H), w (M, C, 3, 3) -> (B, M,
    H-2, H-2) in x's dtype (conv_pallas.py:218-247)."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous())
