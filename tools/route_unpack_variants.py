#!/usr/bin/env python3
"""B8 (the hash-join route unpack, ``csrc/route.cu``) against copies of
itself with one design choice changed, at ``chip_smoke.py`` phase 5's
shapes (n = 2^22, d = 64, m = 64, one rank's routing), on one NVIDIA card.

    python3 tools/route_unpack_variants.py [--seed 0] [--rounds 3]

Run from the root of a checkout.  Each variant is the shipped source with
a text edit (the edit must apply), built by nvcc into the git-ignored
build directory and loaded with ctypes; every variant's output must be the
shipped kernel's bits.  Times are CUDA-event means in turns (the names in
order, then in reverse, ``--rounds`` times), both forms: with the
coefficient and without it.  Prints the card's name and power limit, each
variant's registers (ptxas) and a table of times against the bound."""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

GRID = ("  long long blocks = (n + per_block - 1) / per_block;\n")
PERSISTENT = (
    "  long long blocks = (n + per_block - 1) / per_block;\n"
    "  int per_sm = 0, dev = 0, sms = 0;\n"
    "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,\n"
    "                                                THREADS, 0);\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;\n")
HINTS = ("__ldcg(", "__stcg(")


def hints(src: str, load: str, store: str) -> str:
    return src.replace(HINTS[0], load + "(").replace(HINTS[1], store + "(")


# name: (what changes, edit of the shipped source)
VARIANTS = {
    "V=4": ("4 positions a thread",
            lambda s: s.replace("constexpr int UNPACK_G = 2;",
                                "constexpr int UNPACK_G = 1;")),
    "V=16": ("16 positions a thread",
             lambda s: s.replace("constexpr int UNPACK_G = 2;",
                                 "constexpr int UNPACK_G = 4;")),
    "persistent": ("a grid of SMs x resident blocks looping over the tiles",
                   lambda s: s.replace(GRID, PERSISTENT)),
    "evict-first": ("cell, coeff and out with evict-first hints (.cs)",
                    lambda s: hints(s, "__ldcs", "__stcs")),
    "default": ("cell, coeff and out with default caching (.ca, .wb)",
                lambda s: hints(s, "__ldca", "__stwb")),
    "first-cut": ("the persistent grid and evict-first hints together",
                  lambda s: hints(s.replace(GRID, PERSISTENT), "__ldcs",
                                  "__stcs")),
}


def build(names):
    """{name: loaded library} for each variant, built in parallel."""
    from repro_torch.kernels import _build
    src = (_build.CSRC_DIR / "route.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        edited = VARIANTS[name][1](src)
        if edited == src:
            raise SystemExit(f"variant {name}: its edit does not apply")
        cu = out / f"route_{name}.cu"
        cu.write_text(edited)
        lib = out / f"libroute_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        regs = sorted({int(r) for r in re.findall(
            r"Used (\d+) registers", log)})
        print(f"  {name}: registers a thread over the unpack's instances "
              f"{regs[0]}-{regs[-1]}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.route_unpack_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.route_unpack_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(torch, lib, cell_lay, coeff_lay, back):
    out = torch.empty(tuple(cell_lay.shape) + tuple(back.shape[1:]),
                      device=cell_lay.device)
    rc = lib.route_unpack_launch(
        cell_lay.data_ptr(), None if coeff_lay is None
        else coeff_lay.data_ptr(), back.data_ptr(), out.data_ptr(),
        cell_lay.shape[0], cell_lay.shape[1], back.shape[0],
        1 if back.ndim == 1 else back.shape[1],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"launch failed: {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("route_unpack_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as C
    import repro_torch.core as T
    from repro_torch.data import make_regression
    from repro_torch.kernels.binning import (route_pack_cuda,
                                             route_unpack_cuda)
    from repro_torch.kernels.binning.ops import layout_rows
    from repro_torch.kernels.featurize import featurize_cuda
    print(f"card: {C.card_line()}", flush=True)
    libs = build(list(VARIANTS))
    dev = torch.device("cuda", 0)
    sizes = C.krr_sizes(torch)
    n, d, m, ts = (sizes[k] for k in ("n", "d", "m", "table_size"))
    x = torch.from_numpy(make_regression(n, 16, d, rough=0.5,
                                         seed=args.seed)[0]).to(dev)
    lsh = T.sample_lsh_params(np.random.default_rng(args.seed), m, d,
                              T.GammaPDF(2.0, 1.0), device=dev)
    feats = featurize_cuda(x, *lsh, f=T.RECT, table_size=ts)
    lay, routes = C.split_setup(torch, feats[4], feats[5], ts)
    del feats, x
    cell_lay, used, cap = (routes[0][k] for k in ("cell_lay", "used", "cap"))
    real = lay.src < n
    head = real.clone()
    head[:, 1:] &= (lay.slot_lay[:, 1:] != lay.slot_lay[:, :-1]) | \
        ~real[:, :-1]
    distinct = int(head.sum())
    del real, head
    beta = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        n).astype(np.float32)).to(dev)
    send = route_pack_cuda(cell_lay, lay.coeff_lay * layout_rows(lay, beta),
                           used, cap)
    print(f"  phase 5's routing: m = {m}, L = {cell_lay.shape[1]}, "
          f"{distinct} distinct buckets, {send.shape[0]} cells", flush=True)
    for form, cf in (("with its coefficient", lay.coeff_lay),
                     ("without a coefficient", None)):
        shipped = route_unpack_cuda(cell_lay, cf, send)
        for name, lib in libs.items():
            if not torch.equal(
                    launch(torch, lib, cell_lay, cf, send).view(torch.int32),
                    shipped.view(torch.int32)):
                raise SystemExit(f"variant {name} ({form}): not the shipped "
                                 f"kernel's bits")
        b_ms = C.bound(C.nbytes(cell_lay, shipped) + 4 * distinct
                       + (0 if cf is None else C.nbytes(cf)))[0]
        del shipped
        fns = {"shipped": lambda cf=cf: route_unpack_cuda(cell_lay, cf,
                                                          send)}
        fns.update({name: (lambda lib=lib, cf=cf: launch(
            torch, lib, cell_lay, cf, send)) for name, lib in libs.items()})
        times = {name: [] for name in fns}
        order = list(fns)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                times[name].append(C.time_ms(torch, fns[name], reps=10))
        print(f"B8 {form} (bound {b_ms:.4f} ms by bytes at 3.35 TB/s):",
              flush=True)
        for name, ts_ in times.items():
            mean = sum(ts_) / len(ts_)
            what = "the shipped kernel" if name == "shipped" else \
                VARIANTS[name][0]
            print(f"  {name:12s} {mean:.4f} ms (min {min(ts_):.4f}, max "
                  f"{max(ts_):.4f}; {b_ms / mean:.1%} of the bound): {what}",
                  flush=True)
    print(f"card: {C.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
