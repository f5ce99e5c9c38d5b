"""Input-file benchmark runner, the ``eigenexa_benchmark`` analogue
(counterpart of ``eigenexa_tpu/bench/runner.py``; reference:
benchmark/main2.f:80).  The same input-line format

    N  nvec  bx  by  mode  matrix  solver

    mode   : 0 eigenvalues only | 1 eigenpairs | 2 eigenpairs + eigenvalue
             refinement | 3-6 the stage-isolation modes S/T/C/R
             (main2.f:243-258)
    matrix : 0..10 (``testing.MATRIX_TYPES``), -1/-2 Matrix Market;
             lines starting with '!' or '#' are comments
    solver : 0 eigen_sx | 1 eigen_s | 2 eigen_h (the real matrix cast to
             complex) | 3 eigen_gev (B = designed(linspace(1, 2, n)))

and the same report: configuration, time, model GFLOP/s, collective time
and the PASS/CAUTION/FAIL lines of the ev_test/w_test checks.  Each line
runs on ``--device`` (the card unless ``--device cpu``), in float32 unless
``--f64``.  ``--eigh`` times ``torch.linalg.eigh`` on each line's matrix
after its checks, the incumbent beside the line.

``-x PX PY`` starts PX·PY ranks (``parallel.launch.spawn``) and runs every
line through the distributed drivers on that mesh: eigen_sx, eigen_s,
eigen_h and GEV lines; rank 0 prints the
report with the COMM_STAT block (the reference's -x dimX dimY,
benchmark/main2.f:152-197).  ``-g K`` runs K independent solves of the
line's problem class over K ranks, or over the -x mesh (main2.f:163-174).
``--backend`` is ``nccl`` (a card a rank) unless ``gloo`` is asked for
(the CPU, or every rank on one card).

Usage:  python -m eigenexa_tpu_torch.bench.runner [-f INPUT] [-n N]
            [--mtype K] [--solver S] [--f64] [--profile] [--device DEV]
            [-x PX PY | -g K] [--backend {nccl,gloo}] [--timeout S]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time
from typing import Optional

import torch

from eigenexa_tpu_torch import (eigen_gev, eigen_h, eigen_init, eigen_s,
                                eigen_sx)
from eigenexa_tpu_torch.runtime import SolverConfig
from eigenexa_tpu_torch.testing import (MATRIX_TYPES, b_orthogonality_check,
                                        designed, eigenvalue_check,
                                        gev_residual_check, mat_set,
                                        orthogonality_check, residual_check)

# input `nall` 0..6 -> driver modes (reference: benchmark/main2.f:243-258)
MODE_MAP = {0: "N", 1: "A", 2: "X", 3: "S", 4: "T", 5: "C", 6: "R"}
# the checks take Z in blocks of this many columns above CHUNK_ABOVE, so
# that A·Z is never held whole beside the solve's working set
CHECK_CHUNK = 4096
CHUNK_ABOVE = 16384


@dataclasses.dataclass
class BenchCase:
    n: int
    nvec: int
    bx: int = 64
    by: int = 128
    mode: int = 1
    mtype: int = 0
    solver: int = 1   # 0 = eigen_sx, 1 = eigen_s (reference convention)

    @classmethod
    def parse(cls, line: str) -> Optional["BenchCase"]:
        line = line.strip()
        if not line or line.startswith("!") or line.startswith("#"):
            return None
        vals = [int(p) for p in line.split()[:7]]
        if vals[0] <= 0:
            return None  # reference: N<=0 terminates the loop (main2.f)
        while len(vals) < 7:
            vals.append([0, 0, 64, 128, 1, 0, 1][len(vals)])
        return cls(n=vals[0], nvec=vals[1] or vals[0], bx=vals[2] or 64,
                   by=vals[3] or 128, mode=vals[4], mtype=vals[5],
                   solver=vals[6])


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _stages(info) -> dict:
    """The per-stage seconds and GFLOP/s of a profiled solve."""
    return {k: {"seconds": round(v["seconds"], 4),
                "gflops": round(v["flops"] / v["seconds"] / 1e9, 2)
                if v["seconds"] > 0 else 0.0}
            for k, v in info.stages.items()}


def _check(report: dict, chk) -> bool:
    report["checks"][chk.name] = {"value": chk.value,
                                  "status": chk.status()}
    return chk.hard_fail


def _cusolver_refusal(err: RuntimeError) -> bool:
    msg = str(err)
    return "CUSOLVER_STATUS_INVALID_VALUE" in msg and "bufferSize" in msg


def _incumbent(report: dict, a, b=None, values_only: bool = False,
               printer=print) -> None:
    """``torch.linalg.eigh`` (``eigvalsh`` in mode N) on the line's matrix,
    one call closed by a device barrier; for a generalized line, the
    Cholesky reduction L⁻¹·A·L⁻ᴴ before it and the back-substitution
    after.  cuSOLVER's one documented refusal, the workspace query's
    ``CUSOLVER_STATUS_INVALID_VALUE`` (``eigh`` at n = 32768 on an 80 GB
    card), is recorded, not raised: it is not the solver under test.
    Every other error, an out-of-memory one among them, rises."""
    def sync():
        if a.device.type == "cuda":
            torch.cuda.synchronize(a.device)

    sync()
    t0 = time.perf_counter()
    try:
        if b is None:
            out = (torch.linalg.eigvalsh(a) if values_only
                   else torch.linalg.eigh(a))
        else:
            ell = torch.linalg.cholesky(b)
            c = torch.linalg.solve_triangular(ell, a, upper=False)
            c = torch.linalg.solve_triangular(ell, c.mH, upper=False)
            if values_only:
                out = torch.linalg.eigvalsh(c)
            else:
                w, y = torch.linalg.eigh(c)
                out = (w, torch.linalg.solve_triangular(ell.mH, y,
                                                        upper=True))
        sync()
        report["torch_eigh_s"] = round(time.perf_counter() - t0, 4)
        del out
    except RuntimeError as err:
        if not _cusolver_refusal(err):
            raise
        report["torch_eigh_error"] = str(err)[:200]
    if printer is not None:
        printer(f"    torch.linalg.eigh "
                + (f"{report['torch_eigh_s']} s" if "torch_eigh_s" in report
                   else f"refused: {report['torch_eigh_error']}"))


def run_case(case: BenchCase, ctx=None, dtype=None, w_file=None,
             printer=print, profile: bool = False, device=None,
             eigh: bool = False) -> dict:
    """Run one benchmark line; returns the report dict (the reference
    prints this block from main2.f:420-480).

    The matrix is built once on the context's device (``device``, the card
    by default, where no ``ctx`` is given) and serves the checks too: the
    drivers do not modify their input.  profile=True adds the per-stage
    block (src/eigen_s.F:180-276); eigh=True the incumbent's time."""
    dtype = dtype or torch.float32
    ctx = ctx or eigen_init(device or "cuda", config=SolverConfig(
        panel_forward=case.bx, panel_backward=case.by))
    mode = MODE_MAP.get(case.mode, "A")
    a, w_true = mat_set(case.n, case.mtype, dtype=dtype, device=ctx.device,
                        w_file=w_file)
    if case.solver == 3:
        return _run_gev_case(case, a, ctx, dtype, printer, profile, eigh)
    if case.solver == 0:
        solver_fn, solver_name = eigen_sx, "eigen_sx"
    elif case.solver == 2:
        solver_fn, solver_name = eigen_h, "eigen_h"
        # the JAX package promotes the real matrix in every product; the
        # port casts it once, for the solve and the checks alike
        a = a.to(torch.complex128 if dtype == torch.float64
                 else torch.complex64)
    else:
        solver_fn, solver_name = eigen_s, "eigen_s"

    if mode == "R" and solver_name != "eigen_h":
        # stage-resume: reduce, dump D/E(/F) data, then solve D&C-only from
        # the files (reference: eigen_sx.F:175-193 R-mode file protocol)
        from eigenexa_tpu_torch.utils.stageio import save_stage_data

        with tempfile.TemporaryDirectory() as td:
            if solver_name == "eigen_sx":
                from eigenexa_tpu_torch.ops.band import band2_reduce

                red = band2_reduce(a, nb=case.bx)
                save_stage_data(td, red.d, red.e1, red.e2)
            else:
                from eigenexa_tpu_torch.ops.householder import \
                    tridiagonalize

                red = tridiagonalize(a, nb=case.bx)
                save_stage_data(td, red.d, red.e)
            del red
            w, z, info = solver_fn(a, nvec=case.nvec, mode="R", ctx=ctx,
                                   stage_data=td)
    else:
        w, z, info = solver_fn(a, nvec=case.nvec, mode=mode, ctx=ctx,
                               profile=profile)

    report = {
        "n": case.n,
        "nvec": case.nvec,
        "mode": mode,
        "matrix": MATRIX_TYPES.get(case.mtype, str(case.mtype)),
        "solver": solver_name,
        "grid": "1x1",
        "dtype": _dtype_name(dtype),
        "elapsed_s": round(info.elapsed, 4),
        "model_flops": info.flops,
        "model_gflops": round(info.gflops, 2),
        "comm_s": info.comm_time,
        "checks": {},
    }
    # ev_test / w_test (reference: benchmark/ev_test.f, w_test.f);
    # orthogonality also runs in the stage-isolation modes S/T/R
    # (reference: ev_test.f:194-195)
    chunk = CHECK_CHUNK if case.n > CHUNK_ABOVE else 0
    hard_fail = False
    if z is not None and mode in ("A", "X"):
        hard_fail |= _check(report, residual_check(a, z, w, case.nvec,
                                                   col_chunk=chunk))
    if z is not None and mode in ("A", "X", "S", "T", "R"):
        hard_fail |= _check(report, orthogonality_check(z, case.nvec,
                                                        col_chunk=chunk))
    if w_true is not None and mode in ("N", "A", "X"):
        _check(report, eigenvalue_check(w, w_true))
    del w, z

    if info.stages:
        report["stages"] = _stages(info)
    if printer is not None:
        printer(f"--- {solver_name}  N={case.n} nvec={case.nvec} "
                f"mode={mode} matrix={report['matrix']} "
                f"grid={report['grid']} dtype={report['dtype']}")
        printer(f"    elapsed {report['elapsed_s']} s   "
                f"model {report['model_gflops']} GFLOP/s")
        if info.stages:
            info.stage_report(lambda s: printer("   " + s))
        for name, chk in report["checks"].items():
            printer(f"    *** {name:13s} *** : {chk['status']}  "
                    f"({chk['value']:.4g})")
    if eigh:
        _incumbent(report, a, values_only=mode == "N", printer=printer)
    report["hard_fail"] = hard_fail
    return report


def _run_gev_case(case: BenchCase, a, ctx, dtype, printer,
                  profile: bool = False, eigh: bool = False) -> dict:
    """Generalized-problem line (solver 3): A from `matrix`, B positive
    definite with the designed spectrum linspace(1, 2, n) (reference:
    benchmark/KMATH_EIGEN_GEV_main.f:50, _check.f).  Modes N and A are
    honoured; the other modes run as A with a note (the reference's
    KMATH_EIGEN_GEV.F has no mode argument)."""
    mode = MODE_MAP.get(case.mode, "A")
    if mode not in ("A", "N"):
        if printer is not None:
            printer(f"    (GEV supports modes A/N only; input mode "
                    f"{mode!r} run as 'A' — reference KMATH_EIGEN_GEV.F "
                    f"has no mode argument)")
        mode = "A"
    b = designed(torch.linspace(1.0, 2.0, case.n, dtype=torch.float64),
                 dtype=dtype, device=ctx.device)
    w, z, info = eigen_gev(a, b, nvec=case.nvec, mode=mode, ctx=ctx,
                           profile=profile)
    report = {
        "n": case.n,
        "nvec": case.nvec,
        "mode": mode,
        "matrix": MATRIX_TYPES.get(case.mtype, str(case.mtype)),
        "solver": "eigen_gev",
        "grid": "1x1",
        "dtype": _dtype_name(dtype),
        "elapsed_s": round(info.elapsed, 4),
        "checks": {},
    }
    if mode == "N":
        report.update(nvec=0, hard_fail=False)
        if printer is not None:
            printer(f"--- eigen_gev  N={case.n} mode=N "
                    f"elapsed {report['elapsed_s']} s")
    else:
        report.update(model_flops=info.flops,
                      model_gflops=round(info.gflops, 2),
                      comm_s=info.comm_time, comm_stat={})
        hard_fail = _check(report, gev_residual_check(a, b, z, w,
                                                      case.nvec))
        hard_fail |= _check(report, b_orthogonality_check(z, b, case.nvec))
        report["hard_fail"] = hard_fail
        if printer is not None:
            printer(f"--- eigen_gev  N={case.n} nvec={case.nvec} "
                    f"matrix={report['matrix']} grid={report['grid']} "
                    f"dtype={report['dtype']}")
            printer(f"    elapsed {report['elapsed_s']} s   "
                    f"model {report['model_gflops']} GFLOP/s")
    del w, z
    if info.stages:
        report["stages"] = _stages(info)
    if printer is not None:
        if info.stages:
            info.stage_report(lambda s: printer("   " + s))
        for name, chk in report["checks"].items():
            printer(f"    *** {name:15s} *** : {chk['status']}  "
                    f"({chk['value']:.4g})")
    if eigh:
        _incumbent(report, a, b, values_only=mode == "N", printer=printer)
    return report


def run_input_file(path: str, ctx=None, dtype=None, printer=print,
                   profile: bool = False, device=None, eigh: bool = False):
    """Loop over benchmark input lines (reference: main2.f input loop).
    Returns the list of reports; raises SystemExit on a hard accuracy
    failure (the reference calls MPI_Abort, ev_test.f:215)."""
    reports = []
    with open(path) as f:
        for line in f:
            case = BenchCase.parse(line)
            if case is None:
                continue
            rep = run_case(case, ctx=ctx, dtype=dtype, printer=printer,
                           profile=profile, device=device, eigh=eigh)
            reports.append(rep)
            if rep["hard_fail"]:
                raise SystemExit("hard accuracy failure — aborting "
                                 "(reference behavior: ev_test MPI_Abort)")
    return reports


def _mesh_report(case, solver_name, mode, dtype, mesh, info, a, w, z,
                 w_true, printer, checks_of) -> dict:
    """The report of a distributed line, with its COMM_STAT block (JAX
    ``_run_mesh_case``, bench/runner.py:182).  Z is gathered on every rank
    (a collective); rank 0 alone checks and prints (printer not None)."""
    from eigenexa_tpu_torch.parallel.distributed import (_mesh_overheads,
                                                         gather_matrix)

    if z is not None:
        z = gather_matrix(z, mesh, (case.n, case.nvec))
    report = {
        "n": case.n, "nvec": case.nvec, "mode": mode,
        "matrix": MATRIX_TYPES.get(case.mtype, str(case.mtype)),
        "solver": solver_name + " (distributed)",
        "grid": f"{mesh.px}x{mesh.py}", "dtype": _dtype_name(dtype),
        "elapsed_s": round(info.elapsed, 4), "model_flops": info.flops,
        "model_gflops": round(info.gflops, 2),
        "comm_s": round(info.comm_time, 6),
        "comm_stat": info.comm_stats.report(), "checks": {},
        "hard_fail": False,
    }
    if printer is None:
        return report
    report["hard_fail"] = checks_of(report, z)
    if w_true is not None and mode in ("N", "A", "X"):
        _check(report, eigenvalue_check(w, w_true))
    printer(f"--- {report['solver']}  N={case.n} nvec={case.nvec} "
            f"mode={mode} matrix={report['matrix']} "
            f"grid={report['grid']} dtype={report['dtype']}")
    printer(f"    elapsed {report['elapsed_s']} s   "
            f"model {report['model_gflops']} GFLOP/s   "
            f"comm {report['comm_s']} s")
    # COMM_STAT block (eigen_timer_print, src/eigen_devel.F:440-526)
    for line in info.comm_stats.stat_block(*_mesh_overheads(mesh)):
        printer("    " + line)
    for name, chk in report["checks"].items():
        printer(f"    *** {name:15s} *** : {chk['status']}  "
                f"({chk['value']:.4g})")
    return report


def run_mesh_case(case: BenchCase, mesh, dtype=None, printer=print,
                  w_file=None) -> dict:
    """One benchmark line through the distributed drivers on `mesh`
    (every rank of it calls this; rank 0 passes the printer, the others
    None).  eigen_sx, eigen_s and eigen_h lines take their modes; a GEV
    line modes A and N (others run as A, as on one device)."""
    from eigenexa_tpu_torch.parallel import distributed as D

    dtype = dtype or torch.float32
    cfg = SolverConfig(panel_forward=case.bx, panel_backward=case.by)
    mode = MODE_MAP.get(case.mode, "A")
    a, w_true = mat_set(case.n, case.mtype, dtype=dtype, device=mesh.device,
                        w_file=w_file)
    if case.solver == 3:
        if mode not in ("A", "N"):
            mode = "A"
        b = designed(torch.linspace(1.0, 2.0, case.n, dtype=torch.float64),
                     dtype=dtype, device=mesh.device)
        w, z, info = D.distributed_eigen_gev(a, b, mesh, nvec=case.nvec,
                                             mode=mode, config=cfg,
                                             with_info=True)

        def checks_of(report, z):
            if z is None:
                return False
            return (_check(report, gev_residual_check(a, b, z, w, case.nvec))
                    | _check(report, b_orthogonality_check(z, b,
                                                           case.nvec)))

        return _mesh_report(case, "eigen_gev", mode, dtype, mesh, info, a, w,
                            z, None, printer, checks_of)
    if case.solver == 2:
        a = a.to(torch.complex128 if dtype == torch.float64
                 else torch.complex64)
        drive, name = D.distributed_eigen_h, "eigen_h"
    elif case.solver == 0:
        drive, name = D.distributed_eigen_sx, "eigen_sx"
    else:
        drive, name = D.distributed_eigen_s, "eigen_s"
    w, z, info = drive(a, mesh, nvec=case.nvec, mode=mode, config=cfg,
                       with_info=True)

    def checks_of(report, z):
        hard = False
        if z is not None and mode in ("A", "X"):
            hard |= _check(report, residual_check(a, z, w, case.nvec))
        if z is not None and mode in ("A", "X", "S", "T"):
            hard |= _check(report, orthogonality_check(z, case.nvec))
        return hard

    return _mesh_report(case, name, mode, dtype, mesh, info, a, w, z, w_true,
                        printer, checks_of)


def run_independent(case: BenchCase, k: int, mesh, dtype=None,
                    printer=print) -> dict:
    """`-g` analogue: k independent solves of the line's problem class
    (problem i from seed i), spread over the mesh's ranks (reference:
    main2.f:163-174, MPI_COMM_SELF grids).  Every rank calls this; rank 0
    checks and prints."""
    from eigenexa_tpu_torch.parallel.distributed import independent_solves
    from eigenexa_tpu_torch.utils.sync import device_sync

    dtype = dtype or torch.float32
    mode = MODE_MAP.get(case.mode, "A")
    mats, trues = zip(*(mat_set(case.n, case.mtype, dtype=dtype, seed=i,
                                device=mesh.device) for i in range(k)))
    t0 = time.perf_counter()
    w, z = independent_solves(torch.stack(mats), mesh, nvec=case.nvec,
                              mode=mode, config=SolverConfig(
                                  panel_forward=case.bx,
                                  panel_backward=case.by))
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    report = {"n": case.n, "k": k, "mode": mode,
              "solver": f"eigen_s (independent x{k})",
              "grid": f"{mesh.px}x{mesh.py}",
              "elapsed_s": round(elapsed, 4), "checks": [],
              "hard_fail": False}
    if printer is None:
        return report
    for i in range(k):
        if z is not None:
            r = residual_check(mats[i], z[i], w[i], case.nvec)
            o = orthogonality_check(z[i], case.nvec)
            report["checks"].append({"residual": r.status(),
                                     "orthogonality": o.status()})
            report["hard_fail"] |= r.hard_fail or o.hard_fail
        elif trues[i] is not None:
            report["checks"].append(
                {"eigenvalues": eigenvalue_check(w[i], trues[i]).status()})
    printer(f"--- independent x{k}  N={case.n} grid={report['grid']} "
            f"elapsed {report['elapsed_s']} s")
    for i, c in enumerate(report["checks"]):
        printer(f"    [{i}] " + "  ".join(f"{k2}: {v}"
                                          for k2, v in c.items()))
    return report


def _rank_run(mesh, cases, dtype_name, independent):
    """The runner on one rank of a -x or -g mesh: rank 0 collects the
    printed lines and the reports, the others return None."""
    dtype = getattr(torch, dtype_name)
    lines = []
    printer = lines.append if mesh.index == 0 else None
    if independent:
        reports = [run_independent(cases[0], independent, mesh, dtype,
                                   printer)]
    else:
        reports = [run_mesh_case(case, mesh, dtype, printer)
                   for case in cases]
    return {"lines": lines, "reports": reports} if printer else None


def run_distributed(cases, shape, backend: str, device: str, dtype,
                    independent: int = 0, timeout: float = 3600.0,
                    printer=print):
    """Start the ranks of a `shape` mesh and run the lines `cases` on it
    (or, with `independent` = K, K independent solves of the first line's
    class); print rank 0's report; returns its reports.  A hard accuracy
    failure raises SystemExit after the report, as ``run_input_file``."""
    from eigenexa_tpu_torch.parallel import launch

    out = launch.spawn(_rank_run, tuple(shape), backend, device,
                       list(cases), _dtype_name(dtype), independent,
                       timeout=timeout)[0]
    for line in out["lines"]:
        printer(line)
    if any(rep["hard_fail"] for rep in out["reports"]):
        raise SystemExit("hard accuracy failure — aborting (reference "
                         "behavior: ev_test MPI_Abort)")
    return out["reports"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-f", "--input", help="benchmark input file (IN format)")
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("--nvec", type=int, default=0)
    p.add_argument("--mode", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--mtype", type=int, default=0,
                   help="matrix type 0..10, or -1/-2 for Matrix-Market "
                        "A.mtx/B.mtx in the working directory "
                        "(reference: mat_set.f:220-245)")
    p.add_argument("--solver", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--f64", action="store_true", help="float64 (default "
                   "float32)")
    p.add_argument("--profile", action="store_true",
                   help="per-stage TRD-BLK/D&C/TRDBAK timing block "
                        "(reference: eigen_s.F:180-276)")
    p.add_argument("-x", "--mesh", type=int, nargs=2, metavar=("PX", "PY"),
                   help="run distributed over a PX x PY mesh of ranks "
                        "(reference: main2.f -x dimX dimY)")
    p.add_argument("-g", "--independent", type=int, metavar="K",
                   help="K independent solves over K ranks, or over the "
                        "-x mesh (reference: main2.f -g)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                   help="the ranks' backend under -x/-g: nccl (a card a "
                        "rank, the default) or gloo (the CPU, or every "
                        "rank on one card)")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds the ranks of -x/-g may take")
    p.add_argument("-L", "--list-matrices", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of every solve (default cuda)")
    p.add_argument("--eigh", action="store_true",
                   help="time torch.linalg.eigh on each line's matrix")
    args = p.parse_args(argv)

    if args.list_matrices:
        for k, v in MATRIX_TYPES.items():
            print(f"  {k:3d} : {v}")
        return 0
    dtype = torch.float64 if args.f64 else torch.float32
    if args.mesh or args.independent:
        from eigenexa_tpu_torch.parallel.mesh import factor_grid

        shape = (tuple(args.mesh) if args.mesh
                 else factor_grid(args.independent))
        if args.input:
            with open(args.input) as f:
                cases = [c for c in map(BenchCase.parse, f) if c is not None]
        else:
            cases = [BenchCase(n=args.n, nvec=args.nvec or args.n,
                               mode=args.mode, mtype=args.mtype,
                               solver=args.solver)]
        run_distributed(cases, shape, args.backend, args.device, dtype,
                        independent=args.independent or 0,
                        timeout=args.timeout)
        return 0
    kw = dict(dtype=dtype, profile=args.profile, device=args.device,
              eigh=args.eigh)
    if args.input:
        run_input_file(args.input, **kw)
    else:
        case = BenchCase(n=args.n, nvec=args.nvec or args.n, mode=args.mode,
                         mtype=args.mtype, solver=args.solver)
        run_case(case, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
