"""Start the ranks of a mesh and bring their results back.

The JAX package drives every device from one process and needs no
launcher; the port runs one process per rank.  :func:`spawn` starts px·py
processes with the ``spawn`` start method (never ``fork``: the caller may
already hold a CUDA context), joins them into one ``torch.distributed``
world through a ``FileStore`` in a temporary directory (no fixed TCP port,
so that several callers can run side by side), builds the px × py mesh on
it and calls ``fn(mesh, *args)`` on every rank.

Backend rule, with no silent switch:

* ``"nccl"``: every rank has a card of its own (rank r on ``cuda:r``);
* ``"gloo"``, only when asked for: on the CPU, or with every rank on
  ``cuda:0`` (NCCL refuses two ranks on one card);
* any other combination raises.

On the card the parent builds the kernel library before it starts the
ranks, and each rank loads it, so that no two ranks run ``nvcc`` at once.
On the CPU each rank runs one intra-op thread.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch

BACKENDS = ("nccl", "gloo")


def _check_backend(backend: str, device: str, p: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("nccl needs a card for every rank; a mesh on "
                             "the CPU takes backend='gloo'")
        cards = torch.cuda.device_count()
        if cards < p:
            raise ValueError(
                f"nccl needs a card for every rank: {p} ranks, {cards} "
                "card(s); ranks sharing one card take backend='gloo'")
    elif device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is visible")


def _to_host(x):
    """Tensors (on any device) as numpy arrays, through lists, tuples and
    dicts; everything else as it is (it must pickle)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world, shape, backend, device, store, timeout, fn,
               args, results):
    """One rank: join the world, build the mesh, run fn, report."""
    import torch.distributed as dist

    from eigenexa_tpu_torch.parallel.mesh import build_mesh

    try:
        if device == "cuda":
            from eigenexa_tpu_torch.ops import _build

            dev = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(dev)
            _build.load_library()
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method="file://" + store, world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = build_mesh(shape, device=dev)
            out = fn(mesh, *args)
            if device == "cuda":
                torch.cuda.synchronize()
            results.put((rank, "ok", _to_host(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn, shape, backend: str = "nccl", device: str = "cuda", *args,
          timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` on px·py new processes joined into a mesh of
    `shape` and return their results, ``[result of rank 0, …]``, with every
    tensor in them as a numpy array.

    `fn` and `args` must pickle (a module-level function).  A rank that
    raises fails the call: the other ranks are killed and its traceback is
    raised here.  If the ranks have not all reported after `timeout`
    seconds, they are killed and ``TimeoutError`` is raised; the process
    group is given the same timeout.
    """
    import torch.multiprocessing as mp

    px, py = shape
    p = px * py
    _check_backend(backend, device, p)
    if device == "cuda":
        from eigenexa_tpu_torch.ops import _build

        _build.load_library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, p, (px, py), backend, device, store,
                                   timeout, fn, args, results))
                 for r in range(p)]
        for proc in procs:
            proc.start()
        out = {}
        try:
            while len(out) < p:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(p)) - set(out))} of a "
                        f"{px}x{py} mesh did not finish in {timeout} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 5))
                except queue.Empty:
                    dead = [r for r, proc in enumerate(procs)
                            if r not in out and not proc.is_alive()
                            and proc.exitcode != 0]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} of a {px}x{py} mesh died "
                            f"(exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of a {px}x{py} mesh "
                                       f"failed:\n{value}")
                out[rank] = value
            for proc in procs:
                proc.join(max(deadline - time.monotonic(), 1))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
            results.close()
    return [out[r] for r in range(p)]

