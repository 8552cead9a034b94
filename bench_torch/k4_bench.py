#!/usr/bin/env python3
"""Times kernel K4 (the ELL gather product, ``csrc/ell_gather.cu``) on one GPU.

    python3 bench_torch/k4_bench.py [--root DIR] [--label NAME] [--group-sweep]
                                    [--stack-only] [--wide] [--slab-sweep]

Imports ``pydnmfk_tpu_torch`` from DIR (default: the root of this
checkout), so that two trees, say a parent commit unpacked with ``git archive``
and the change, can be timed in one run on one card, in turns (parent,
change, change, parent). The cases are those of ``chip_smoke.py``'s phase 2:
a 10-member stack of the sparse NMFk sweep's planted topic matrix (200000 x
50000, about 10 M nnz, member values perturbed by up to 3 %) at k = 3 (KP =
4) and k = 7 (KP = 8), and the NYTimes bag-of-words shape (300000 x 102660,
69.6 M nnz) at k = 32, each in K4's four modes (rows/columns, plain/ratio),
all drawn from the same seed. For each case it prints one JSON line: the
kernel's ms (CUDA events, median of 7 after a warm-up), its max relative
and absolute error against the plain version, its bound (the larger of the
operations over 67 TFLOP/s and the bytes, each input read once and the
output written once, nonzeros only, over 3.35 TB/s) and, for the plain modes,
a library call that computes the same product and that the port never
calls: ``torch.bmm`` of a 3-D sparse COO stack against the table (the
stack), ``torch.sparse.mm`` of a CSR matrix (NYTimes). ``interleave_ms`` is
the wrapper's copy of the table into member groups alone (part of ``ms``;
null where the kernel takes the table as it is).

With ``--group-sweep`` it times the stack's cases instead with the members
gathered in groups of 1, 2, 4 and 8 (``ell_gather._launch``'s ``group``) and
with the wrapper's own plan (``"group_asked": null``), twice, in rising and
then falling order. ``--stack-only`` leaves out the NYTimes cases (for a
profiler that takes the stack's launches).

With ``--wide`` it times K4 past k = 32 instead: NYTimes at k = 64, 128,
256 and 300 and the stack at k = 64, four modes each, with, where the
package plans slabs, their count. With ``--slab-sweep`` it times the plain
and ratio modes of the same cases at forced slab widths of 16 to 256
floats (``ell_gather._launch``'s ``slab``) and at the plan's, twice, in
rising and then falling order, with the share of the L2 that one member's
slab of the table fills: the sweep that sets ``ell_gather.SLAB_SHARE``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

import torch

from k1_bench import PEAK_BYTES, median_ms

PEAK_FLOPS = 67e12        # H100 SXM: f32 outside the tensor cores
ENS = 10                  # members of the NMFk ensemble
TOPIC = dict(m=200_000, n=50_000, k=4, nnz_per_row=50)
NYT_M, NYT_N, NYT_NNZ = 300_000, 102_660, 69_679_427
SWEEP = [1, 2, 4, 8, None]   # --group-sweep: members per gathered group
SLABS = [16, 24, 32, 48, 64, 96, 128, 256, None]   # --slab-sweep widths
WIDE_K = [64, 128, 256, 300]  # --wide: NYTimes widths (the stack at 64)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def coo_stack(rows, cols, data, shape):
    """A (B, m, n) sparse COO tensor of B members over one pattern."""
    B, nnz = data.shape
    member = torch.arange(B, device=data.device).repeat_interleave(nnz)
    ind = torch.stack([member, rows.long().repeat(B), cols.long().repeat(B)])
    return torch.sparse_coo_tensor(ind, data.reshape(-1), (B, *shape)).coalesce()


def csr(rows, cols, vals, shape):
    order = torch.argsort(rows.long() * shape[1] + cols.long())
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows.long(), minlength=shape[0]), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # CSR is "beta"
        return torch.sparse_csr_tensor(crow, cols[order].long(), vals[order],
                                       shape, check_invariants=False)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    p.add_argument("--group-sweep", action="store_true",
                   help="time the stack at several member groups instead")
    p.add_argument("--stack-only", action="store_true",
                   help="leave out the NYTimes cases")
    p.add_argument("--wide", action="store_true",
                   help="time K4 past k = 32 instead")
    p.add_argument("--slab-sweep", action="store_true",
                   help="time K4 past k = 32 at several slab widths instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k4_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from pydnmfk_tpu_torch.ops import ell, ell_gather, sparse
    from pydnmfk_tpu_torch.utils.data_generator import generate_topic_sparse

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)

    def modes(E, W, H):
        """(label, vals, idx, table, X, nonzeros, orientation) of the four
        modes on the ELL E with factors W (.., m, k), H (.., k, n)."""
        Ht = H.mT.contiguous()
        nz_r = E.nse - E.rtail_d.shape[-1]
        nz_c = E.nse - E.ctail_d.shape[-1]
        return (("rows plain", E.rvals, E.rcols, Ht, None, nz_r, "r"),
                ("columns plain", E.cvals, E.crows, W, None, nz_c, "c"),
                ("rows ratio", E.rvals, E.rcols, Ht, W, nz_r, "r"),
                ("columns ratio", E.cvals, E.crows, W, Ht, nz_c, "c"))

    def work(v, i, T, X, nz):
        members = v.numel() // i.numel()
        k = T.shape[-1]
        flops = (2 if X is None else 4) * nz * k * members
        moved = (nz * (members * v.element_size() + i.element_size())
                 + nbytes(T) + (0 if X is None else nbytes(X))
                 + 4 * members * i.shape[0] * k)
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def errors(out, ref):
        d = float((out.double() - ref.double()).abs().max())
        return d / float(ref.double().abs().max()), d

    def slabs(T, ratio):
        """The slabs the package plans for T (None where it plans none)."""
        if not hasattr(ell_gather, "slab_for"):
            return None
        return ell_gather.slab_for(T.shape[-2], T.shape[-1], T.device,
                                   ratio=ratio)[1]

    def cases(name, E, W, H, library):
        for label, v, i, T, X, nz, side in modes(E, W, H):
            out = ell_gather.ell_gather_product(v, i, T, X, eps)
            ref = ell_gather.ell_gather_product_plain(v, i, T, X, eps)
            rel, abs_ = errors(out, ref)
            del out, ref
            lib = library.get(side) if X is None else None
            bound_ms, bound_by = work(v, i, T, X, nz)
            copy_ms = None            # the table's interleave, inside ms
            if hasattr(ell_gather, "grouped_table") and T.shape[-1] <= 32:
                T3 = T if T.dim() == 3 else T[None]
                kp, G = ell_gather.group_for(*T3.shape, T.device)
                if G and not (G == 1 and T.shape[-1] == kp):
                    copy_ms = median_ms(
                        lambda: ell_gather.grouped_table(T3, G, kp))
            print(json.dumps({
                "label": args.label, "case": name, "mode": label,
                "ms": median_ms(lambda: ell_gather.ell_gather_product(
                    v, i, T, X, eps)),
                "max_rel_err": rel, "max_abs_err": abs_,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "slabs": slabs(T, X is not None),
                "library_ms": None if lib is None else median_ms(lib),
                "interleave_ms": copy_ms, "card": smi}), flush=True)

    def sweep(name, E, W, H):
        for label, v, i, T, X, nz, _ in modes(E, W, H):
            ref = ell_gather.ell_gather_product_plain(v, i, T, X, eps)
            for asked in SWEEP + SWEEP[::-1]:
                run = lambda: ell_gather._launch(v, i, T, X, eps, group=asked)
                rel, _ = errors(run(), ref)
                print(json.dumps({
                    "label": args.label, "case": name, "mode": label,
                    "group_asked": asked, "group": ell_gather.group_for(
                        *T.shape, T.device, asked)[1],
                    "ms": median_ms(run),
                    "max_rel_err": rel, "card": smi}), flush=True)

    def slab_sweep(name, E, W, H):
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        for label, v, i, T, X, nz, _ in modes(E, W, H):
            ref = ell_gather.ell_gather_product_plain(v, i, T, X, eps)
            k, dim_t = T.shape[-1], T.shape[-2]
            widths = [s for s in SLABS if s is None or s <= k]
            for asked in widths + widths[::-1]:
                ks, count = ell_gather.slab_for(dim_t, k, T.device, asked,
                                                X is not None)
                run = lambda: ell_gather._launch(v, i, T, X, eps, slab=asked)
                rel, _ = errors(run(), ref)
                print(json.dumps({
                    "label": args.label, "case": name, "mode": label,
                    "slab_asked": asked, "slab": ks, "slabs": count,
                    "l2_share": dim_t * -(-ks // 4) * 4 * 4 / l2,
                    "ms": median_ms(run), "max_rel_err": rel,
                    "card": smi}), flush=True)
            del ref

    wide = args.wide or args.slab_sweep
    # the stack: the sweep's planted topic matrix, perturbed per member
    r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
    topic = sparse.from_coo(*(torch.from_numpy(x).to(dev) for x in (r, c, v)),
                            tshape)
    del r, c, v
    Et, *perms = ell.ell_pack(topic, return_perms=True)
    noise = 1.0 + 0.03 * torch.rand((ENS, topic.nse), generator=gen, device=dev)
    data = topic.data * noise
    stack = ell.ell_with_data(Et, *perms, data)
    for k in (64,) if wide else (3, 7):
        W = torch.rand((ENS, tshape[0], k), generator=gen, device=dev)
        H = torch.rand((ENS, k, tshape[1]), generator=gen, device=dev)
        name = (f"{ENS} x {tshape[0]}x{tshape[1]} ({topic.nse} nnz) k={k} "
                f"f32")
        if args.group_sweep:
            sweep(name, stack, W, H)
            continue
        if args.slab_sweep:
            slab_sweep(name, stack, W, H)
            continue
        A_r = coo_stack(topic.rows, topic.cols, data, tshape)
        A_c = coo_stack(topic.cols, topic.rows, data, tshape[::-1])
        Ht = H.mT.contiguous()
        cases(name, stack, W, H, {"r": lambda: torch.bmm(A_r, Ht),
                                  "c": lambda: torch.bmm(A_c, W)})
        del A_r, A_c, Ht
    del topic, Et, perms, noise, data, stack
    torch.cuda.empty_cache()
    if args.group_sweep or args.stack_only:
        return

    # NYTimes: flat positions drawn uniformly with replacement, repeats
    # dropped; geometric counts-like values (as chip_smoke.py draws them)
    flat = torch.unique(torch.randint(0, NYT_M * NYT_N, (NYT_NNZ,),
                                      generator=gen, device=dev))
    vals = torch.floor(-2.0 * torch.log1p(-torch.rand(
        flat.shape, generator=gen, device=dev))) + 1.0
    nyt = sparse.SparseTriplet(vals, (flat // NYT_N).to(torch.int32),
                               (flat % NYT_N).to(torch.int32), (NYT_M, NYT_N))
    del flat, vals
    E = ell.ell_pack(nyt)
    A_r = csr(nyt.rows, nyt.cols, nyt.data, nyt.shape)
    A_c = csr(nyt.cols, nyt.rows, nyt.data, nyt.shape[::-1])
    widths = WIDE_K if wide else [32]
    for k in widths:
        W = torch.rand((NYT_M, k), generator=gen, device=dev)
        H = torch.rand((k, NYT_N), generator=gen, device=dev)
        name = f"{NYT_M}x{NYT_N} ({nyt.nse} nnz) k={k} f32"
        if args.slab_sweep:
            slab_sweep(name, E, W, H)
            continue
        Ht = H.mT.contiguous()
        cases(name, E, W, H, {"r": lambda: torch.sparse.mm(A_r, Ht),
                              "c": lambda: torch.sparse.mm(A_c, W)})
        del W, H, Ht


if __name__ == "__main__":
    main()
