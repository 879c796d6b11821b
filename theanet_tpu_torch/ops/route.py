"""The JAX package's byte models of its fused kernels, restated on shapes.

A fused family in the port takes a spec when its grammar holds and either
the JAX package's byte model admits the spec or the spec's head fits a
block's shared memory (``megastep.route_reason``). The byte models are the
JAX package's VMEM gates, in their striped form (``group_g`` 1: off a TPU
the JAX package decides on the striped layout and tries the grouped one
only after that layout passes):

  * the flagship's tile search and ``flagship_vmem_ok``
    (theanet_tpu/ops/megastep.py:524-557 and :345-407), with the constant
    shapes of ``build_constants`` (:844), ``_geometry_constants`` (:820),
    ``stack_shapes`` (:1001) and ``kernel_shapes`` (:1156, the port's
    ``megastep.kernel_shapes``);
  * the deep family's ``_fits_vmem`` (megastep_deep.py:578-649), with
    ``build_constants_deep`` (:802), ``deep_kernel_shapes`` (:890, the
    port's own) and ``deep_stack_shapes`` (:916);
  * the flat MLP's 24 MB gate (megastep_mlp.py:137-152), with
    ``build_constants_mlp`` (:157) and ``flat_embed_bytes``
    (megastep.py:305).

Everything here is arithmetic on a spec's fields: no arrays, no kernel.
Each ``*_bytes`` function returns (constants, state, work) in bytes, the
three terms the JAX gate sums against its budget. A tiled JAX spec is one
step of the whole reference batch in the port (``flagship_tiling`` only
says whether the JAX package fuses it, and how it would tile).
"""

from __future__ import annotations

import math

__all__ = ["FLAGSHIP_BUDGET", "DEEP_BUDGET", "FLAT_BUDGET",
           "flagship_const_shapes", "flagship_bytes", "flagship_vmem_ok",
           "flagship_tiling", "flagship_jax_reason", "deep_const_shapes",
           "deep_bytes", "deep_fits_vmem", "deep_jax_reason", "mlp_bytes",
           "mlp_jax_reason"]

MB = 1024 * 1024
FLAGSHIP_BUDGET = 40 * MB   # megastep.py:404-407
DEEP_BUDGET = 22 * MB       # megastep_deep.py:647-649, conv stacks
FLAT_BUDGET = 24 * MB       # flat nets: megastep_mlp.py:151, deep :647


def _pad8(n):
    return -(-n // 8) * 8


def _elems(shapes):
    return sum(math.prod(s) for s in shapes)


def _smooth_shape(spec):
    """``smoothing_const``: the (hw, hw) kron operand, or an (8, 128)
    placeholder when no elastic field is drawn."""
    return (spec.hw, spec.hw) if spec.magnitude else (8, 128)


def _flat_embed_bytes(spec):
    """megastep.py:305 ``flat_embed_bytes``."""
    from .megastep import warp_active

    b = 4 * spec.in_ch * spec.batch * spec.hw * (1 + spec.in_ch)
    if warp_active(spec):
        b += 4 * spec.hw * spec.hw
    return b


# ---------------------------------------------------------------- flagship

def flagship_const_shapes(spec):
    """Shapes of ``build_constants(spec)``, striped, in its key order."""
    B, M1, M2, C0 = spec.batch, spec.maps1, spec.maps2, spec.in_ch
    hw, s1, s2 = spec.hw, spec.p1 ** 2, spec.p2 ** 2
    t1, t2 = spec.filt1 ** 2, spec.filt2 ** 2
    cbp, r1p = _pad8(C0 * B), _pad8(M1 * B)
    return [
        _smooth_shape(spec),            # s_smooth
        (hw, s1), (s1, s2),             # c1, c2
        (1, hw), (1, s1),               # valid1, valid2
        (hw, s1), (s1, s2),             # mem1, mem2
        (t2 * s1, s1),                  # sh2
        (M1 * B, M1), (M2 * B, M2),     # em1, em2
        (M1 * B, t1 * cbp), (M2 * B, t2 * r1p),       # st1x, st2x
        (t1 * C0, t1 * cbp), (t2 * M1, t2 * r1p),     # e9b1, e9b2
        (M2 * B, spec.n_flat), (spec.n_flat, s2),     # selmask, selsum
        (B, M2 * B),                    # sumsel
    ]


def flagship_bytes(spec, n_tiles=1):
    """(constants, state, work) bytes of ``flagship_vmem_ok`` at
    ``spec.batch`` (the tile) and ``n_tiles`` tiles a reference batch."""
    from .megastep import kernel_shapes

    B, hw = spec.batch, spec.hw
    const = 4 * _elems(flagship_const_shapes(spec))
    state = 4 * _elems(kernel_shapes(spec)) * (4 + (1 if n_tiles > 1 else 0))
    st2x = (spec.maps2 * B) * (spec.filt2 ** 2 * spec.maps1 * B)
    work = 4 * (hw * B * (spec.filt1 ** 2 * spec.in_ch + 5 * spec.maps1)
                + spec.filt1 ** 2 * _pad8(spec.in_ch * B) * hw
                + spec.filt2 ** 2 * spec.maps1 * B * spec.p1 ** 2
                + 5 * spec.maps2 * B * spec.p1 ** 2
                + 8 * B * spec.n_hid
                + 2 * st2x)
    return const, state, work


def flagship_vmem_ok(spec, n_tiles=1):
    return sum(flagship_bytes(spec, n_tiles)) <= FLAGSHIP_BUDGET


def flagship_tiling(spec):
    """(tile, n_tiles) of the JAX package's tile search at ``spec.batch``
    (the reference batch), or None when no candidate fits its budget:
    divisors of BATCH_SZ from 32 down to 4, then BATCH_SZ untiled; at most
    32 untiled only."""
    B = spec.batch
    cands = ([B] if B <= 32 else
             [d for d in range(32, 3, -1) if B % d == 0] + [B])
    for bt in cands:
        if flagship_vmem_ok(spec._replace(batch=bt), B // bt):
            return bt, B // bt
    return None


def flagship_jax_reason(spec):
    """None when the JAX package fuses ``spec`` in the flagship family,
    else why its byte model declines it."""
    if flagship_tiling(spec) is not None:
        return None
    total = sum(flagship_bytes(spec))
    return (f"the JAX package's flagship VMEM model declines BATCH_SZ "
            f"{spec.batch} at every tile (untiled {total:,} bytes; budget "
            f"{FLAGSHIP_BUDGET:,})")


# -------------------------------------------------------------------- deep

def deep_const_shapes(spec):
    """Shapes of ``build_constants_deep(spec)``, striped, in its key
    order."""
    B = spec.batch
    out = [_smooth_shape(spec)]
    sides = spec.sides
    prev = spec.in_ch
    for k, (grid, _, po) in enumerate(sides):
        mk, taps, p = spec.maps[k], spec.filts[k] ** 2, grid * grid
        cbp = _pad8(prev * B)
        nxt_full = k + 1 < spec.n_levels and spec.mode(k + 1) == "full"
        cols = sides[k + 1][0] ** 2 if nxt_full else po * po
        out += [(p, cols), (1, p), (p, cols),       # c, valid, mem
                (taps, p),                          # tm
                (mk * B, mk),                       # em
                (taps * prev, taps * cbp),          # e9b
                (mk * B, taps * cbp)]               # stx
        if k == 0 and spec.mode(0) == "full":
            out.append((spec.hw, p))                # e0
        if k > 0:
            out.append((taps * p, p))               # sh
        prev = mk
    if spec.n_levels == 0:
        out.append((B, spec.in_ch * B))             # sumsel
    else:
        mn, pn2 = spec.maps[-1], sides[-1][2] ** 2
        out.append((B, mn * B))                     # sumsel
        if spec.mean_tail:
            out += [(mn * B, mn), (mn, pn2)]        # selmask, selsum
        else:
            out += [(mn * B, mn * pn2), (mn * pn2, pn2)]
    if spec.head in ("logit", "rbf") and not spec.learn_centers:
        out.append((spec.n_classes, spec.n_out))    # centers
    if spec.aux_concat:
        nah, nao = spec.aux_concat
        out += [(2, nah), (1, nah), (nah, nao), (1, nao)]
    return out


def deep_bytes(spec):
    """(constants, state, work) bytes of ``_fits_vmem`` at
    ``spec.batch``."""
    from .megastep_deep import deep_kernel_shapes

    B = spec.batch
    const = 4 * _elems(deep_const_shapes(spec))
    state = 4 * 3 * _elems(deep_kernel_shapes(spec))
    if spec.n_levels == 0:
        work = _flat_embed_bytes(spec)
    else:
        s0sq = spec.sides[0][0] ** 2
        f0sq = spec.filts[0] ** 2
        work = 4 * (s0sq * B * (f0sq * spec.in_ch + 5 * spec.maps[0])
                    + spec.hw * B * spec.in_ch
                    + f0sq * _pad8(spec.in_ch * B) * s0sq)
    for k in range(1, spec.n_levels):
        lanes = spec.sides[k][0] ** 2
        fk2 = spec.filts[k] ** 2
        rp = spec.maps[k - 1] * B
        work += 4 * (2 * fk2 * rp * lanes + 2 * fk2 * spec.maps[k] * rp * B
                     + 5 * spec.maps[k] * B * lanes)
    work += 4 * 8 * B * spec.n_hid
    for ph in spec.pre_hidden:
        work += 4 * 8 * B * ph[0]
    if spec.head != "softmax":
        work += 4 * 6 * B * (spec.n_out + spec.n_classes)
    if spec.aux_concat:
        work += 4 * 8 * B * (sum(spec.aux_concat) + 4)
    return const, state, work


def _deep_budget(spec):
    return FLAT_BUDGET if spec.n_levels == 0 else DEEP_BUDGET


def deep_fits_vmem(spec):
    return sum(deep_bytes(spec)) <= _deep_budget(spec)


def deep_jax_reason(spec):
    """None when the JAX package's deep byte model admits ``spec``, else
    why not."""
    if deep_fits_vmem(spec):
        return None
    return (f"the JAX package's deep VMEM model declines it "
            f"({sum(deep_bytes(spec)):,} bytes; budget "
            f"{_deep_budget(spec):,})")


# ---------------------------------------------------------------- flat MLP

def mlp_bytes(spec):
    """(constants, state, work) bytes of the flat-MLP gate in
    ``mlp_spec_from_net``."""
    from .megastep_mlp import mlp_kernel_shapes

    B = spec.batch
    const = 4 * _elems([_smooth_shape(spec), (B, spec.in_ch * B)])
    state = 4 * 3 * _elems(mlp_kernel_shapes(spec))
    work = _flat_embed_bytes(spec) + 4 * 8 * B * spec.n_hid
    return const, state, work


def mlp_jax_reason(spec):
    """None when the JAX package's flat-MLP gate admits ``spec``, else why
    not."""
    total = sum(mlp_bytes(spec))
    if total <= FLAT_BUDGET:
        return None
    return (f"the JAX package's flat-MLP VMEM model declines it "
            f"({total:,} bytes; budget {FLAT_BUDGET:,})")
