"""Field and point microbenchmarks: the JAX package's harness/microbench.py
on the port.

run() times, at `lanes` lanes, each operation of the JAX microbench, a
row each: "_torch" rows are the plain PyTorch forms on the device (the
JAX package's "_xla" rows), "_cuda" rows the hand-written kernels (its
"_pallas" rows).  Each row names the entry point it launched:

  mont_mul_torch            ops/field.py mont_mul
  barrett_mul_torch         ops/field.py barrett_mul (vanilla Barrett)
  point_add_torch           the group's plain complete add (ops/curve.py)
  masked_add_mixed_cuda     ops/buckets.py legacy_buckets over one-entry
                            buckets (csrc/legacy.cu msm_legacy_buckets)
  add_lazy_cuda             ops/kernels.py bpr_add (csrc/bpr.cu
                            msm_bpr_add): the lazy add, where the JAX
                            row's add is canonical
  double_and_add_step_cuda  ops/kernels.py scalar_mult, bits=1
                            (csrc/canon.cu msm_scalar_mult)
  mont_mul_cuda             ops/kernels.py field_mul_lanes (csrc/tree.cu
                            msm_field_mul_lanes: a product and a paired
                            product a lane)

Each time is the mean of `iters` calls after a warm one, fenced
(utils/timing.py).  On the CPU every row runs the plain forms.

product_study() replaces the JAX limb-width study (the TPU's limb widths;
the port's field is fixed at 13 or 9 32-bit words): it times tree.cu's
rate kernel (msm_word_rate: many blocks a SM, each thread a chain of
dependent Montgomery products, no memory traffic but one store) in each
product form: the carry chain (the default build) and the C form (a
-DMSM_MONT_C build, ops/kernels.py:build_variants), each first held
against the kernel's plain form, and reports word products/s and the
card's nanoseconds per Montgomery product.

Run: python -m webgpu_msm_bls12_377_tpu_torch.harness.microbench --lanes 524288
     python -m webgpu_msm_bls12_377_tpu_torch.harness.microbench --product-study
     python -m webgpu_msm_bls12_377_tpu_torch.harness.microbench --lanes 256 \\
         --iters 1 --device cpu                     # plain forms
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import time

import numpy as np
import torch

from ..models.cuzk import resolve_device
from ..ops import curve as C
from ..ops import field as F
from ..ops import kernels as K
from ..ops.buckets import SIGN_BIT, legacy_buckets
from ..params import CurveId
from ..utils.timing import time_fn

#: the product study's forms: extra nvcc flags of tree.cu's build
FORMS = {"chain": (), "c_form": ("-DMSM_MONT_C",)}
#: the rate kernel's launch: blocks a SM (many waves, so the last one's
#: tail is small) and dependent Montgomery products a thread
RATE_BLOCKS_PER_SM, RATE_ITERS = 64, 32
#: lanes of the rate kernel's output held against its plain form
CHECK_LANES = 1024


def _plane(rng, ctx, rows: int, lanes: int, device) -> torch.Tensor:
    """(rows, lanes) int32 plane of random canonical values: each
    coordinate's words above p's top word zero and that word below p's,
    so every value is below p."""
    w = rng.randint(0, 1 << 32, size=(rows, lanes), dtype=np.uint64)
    k = (ctx.p.bit_length() - 1) // 32
    w = w.reshape(rows // ctx.nw, ctx.nw, lanes)
    w[:, k] %= ctx.p >> (32 * k)
    w[:, k + 1:] = 0
    w = w.reshape(rows, lanes)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def run(curve: CurveId, lanes: int, iters: int, device=None) -> dict:
    """Each operation's time at `lanes` lanes on `device` (None: the first
    CUDA device): {"curve", "lanes", "word_size", "num_words", "device",
    and per operation {"ms", "M_ops_per_s", "entry"}}."""
    dev = resolve_device(device)
    group = C.group_ops(curve)
    ctx = group.ctx
    rng = np.random.RandomState(11)
    x, y = (_plane(rng, ctx, ctx.nw, lanes, dev) for _ in range(2))
    point = _plane(rng, ctx, group.rows, lanes, dev)
    aff = _plane(rng, ctx, group.aff_rows, lanes, dev)
    table = K.build_signed_table(aff, group)
    sign = rng.randint(0, 2, lanes).astype(np.int64)
    vals = torch.from_numpy(
        (np.arange(lanes) | (sign << SIGN_BIT)).astype(np.int32)).to(dev)
    starts = torch.arange(lanes, dtype=torch.int32, device=dev)
    ones = torch.ones(lanes, dtype=torch.int32, device=dev)
    scalars = torch.from_numpy(rng.randint(0, 1 << 32, size=(8, lanes),
                                           dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev)

    def point_add(a, b):
        return C.merge(group.add(group.split(a), group.split(b)))

    ops = {
        "mont_mul_torch": ("ops/field.py mont_mul", F.mont_mul, (x, y, ctx)),
        "barrett_mul_torch": ("ops/field.py barrett_mul", F.barrett_mul,
                              (x, y, ctx)),
        "point_add_torch": (f"ops/curve.py {type(group).__name__}.add",
                            point_add, (point, point)),
        "masked_add_mixed_cuda": (
            "ops/buckets.py legacy_buckets over one-entry buckets "
            "(csrc/legacy.cu msm_legacy_buckets)", legacy_buckets,
            (table, vals, starts, ones, group)),
        "add_lazy_cuda": (
            "ops/kernels.py bpr_add (csrc/bpr.cu msm_bpr_add): lazy; the "
            "JAX row's add is canonical", K.bpr_add, (point, point, group)),
        "double_and_add_step_cuda": (
            "ops/kernels.py scalar_mult, bits=1 (csrc/canon.cu "
            "msm_scalar_mult)", K.scalar_mult, (aff, scalars, 1, group)),
        "mont_mul_cuda": (
            "ops/kernels.py field_mul_lanes (csrc/tree.cu "
            "msm_field_mul_lanes: a product and a paired product a lane)",
            K.field_mul_lanes, (x, y, x, y, ctx)),
    }
    out = {
        "curve": curve.value,
        "lanes": lanes,
        "word_size": 32,
        "num_words": ctx.nw,
        "device": dev.type,
    }
    for name, (entry, fn, args) in ops.items():
        t = time_fn(fn, *args, iters=iters)
        out[name] = {
            "ms": round(t * 1000, 3),
            "M_ops_per_s": round(lanes / t / 1e6, 2),
            "entry": entry,
        }
    return out


@functools.lru_cache(maxsize=None)
def _form_libs(form: str) -> dict:
    """tree.cu's libraries (both fields) built with the form's flags."""
    dirs = K.build_variants(("tree",), {form: FORMS[form]})
    return K.load_variant(dirs[form], ("tree",))


def _ms(fn, on_card: bool) -> float:
    """One call's milliseconds: CUDA events on the card, else the host
    clock."""
    if on_card:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def product_study(curve: CurveId, forms=tuple(FORMS), iters: int = RATE_ITERS,
                  repeats: int = 5, device=None,
                  blocks: int | None = None) -> dict:
    """The rate kernel's time in each product form of `forms` (FORMS'
    keys) for the curve's field: each form's output first held against
    the plain form (CHECK_LANES lanes), then the median of `repeats`
    launches after that one.  blocks None: RATE_BLOCKS_PER_SM a SM on the
    card, one block on the CPU (where every form is the plain form)."""
    dev = resolve_device(device)
    ctx = F.field_ctx(curve)
    on_card = dev.type == "cuda"
    if blocks is None:
        blocks = (torch.cuda.get_device_properties(dev).multi_processor_count
                  * RATE_BLOCKS_PER_SM if on_card else 1)
    out = torch.empty(blocks * K.RATE_THREADS, dtype=torch.int32, device=dev)
    lanes = min(CHECK_LANES, out.numel())
    want = K.word_rate_plain(lanes, iters, ctx, dev)
    products = blocks * K.RATE_THREADS * iters  # Montgomery products
    word_products = products * 2 * ctx.nw ** 2
    res = {"curve": curve.value, "num_words": ctx.nw, "device": dev.type,
           "blocks": blocks, "threads": K.RATE_THREADS, "iters": iters,
           "word_products": word_products, "forms": {}}
    for form in forms:
        libs = _form_libs(form) if on_card and FORMS[form] else None
        with K.using(libs) if libs else contextlib.nullcontext():
            K.word_rate(out, iters, ctx)
            if not torch.equal(out[:lanes], want):
                raise AssertionError(
                    f"{form}: the rate kernel's words differ from its plain "
                    "form")
            times = [_ms(lambda: K.word_rate(out, iters, ctx), on_card)
                     for _ in range(repeats)]
        ms = statistics.median(times)
        res["forms"][form] = {
            "flags": list(FORMS[form]),
            "ms": ms,
            "times_ms": times,
            "word_products_per_s": word_products / (ms / 1e3),
            "ns_per_product": ms * 1e6 / products,
        }
    return res


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--curve", default="bls12_377",
                    choices=["bls12_377", "edwards_bls12"])
    ap.add_argument("--product-study", action="store_true",
                    help="the rate kernel in the carry-chain and the C-form "
                         "product: word products/s")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain forms)")
    args = ap.parse_args(argv)
    curve = CurveId(args.curve)
    if args.product_study:
        print(json.dumps(product_study(curve, device=args.device), indent=2))
        return
    print(json.dumps(run(curve, args.lanes, args.iters, args.device),
                     indent=2))


if __name__ == "__main__":
    main()
