"""The process group under a mesh, with its transport named.

* ``nccl`` on CUDA, one rank per card: the production path (``torchrun``).
* ``gloo`` on the CPU: the tests.
* ``gloo`` over CUDA tensors for ranks that share one card. Gloo runs some
  collectives on CUDA tensors and not others (a missing one can abort the
  process), so :func:`probe_gloo_cuda` tries each in a process group of its
  own, and :func:`stage_through_host` routes exactly the missing ones
  through pinned host memory: their functional-collective kernels for CUDA
  (``torch.ops._c10d_functional``, the ops DTensor and the port's explicit
  collectives call) copy the operand to the host, run gloo's CPU
  collective and copy the result back. The compute stays on the card.

A mesh asked for on CUDA with more ranks than cards over ``nccl`` raises:
NCCL refuses two ranks of one communicator on one GPU. Nothing switches the
backend or the device on its own.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_state = threading.local()


def init_ranks(rank: int, world: int, port: int, *, device: str = "cpu",
               backend: Optional[str] = None,
               staged: Sequence[str] = ()) -> torch.device:
    """Start this rank's default process group at
    ``tcp://localhost:<port>`` and return the rank's device. ``backend``
    defaults to ``nccl`` on CUDA and ``gloo`` on the CPU; ``staged`` names
    the collectives gloo lacks on CUDA (:func:`probe_gloo_cuda`), which go
    through the host (:func:`stage_through_host`)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise ValueError(
                f"backend='nccl' needs a card per rank: {world} ranks, "
                f"{cards} card(s); pass backend='gloo' for ranks that share "
                "a card")
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    _state.device_type = dev.type
    if staged:
        if not (dev.type == "cuda" and backend == "gloo"):
            raise ValueError("host staging is the gloo transport of ranks "
                             "that share a card")
        stage_through_host(staged)
    return dev


# ---------------------------------------------------------------------------
# Ranks that share a card: gloo over CUDA tensors, staged where it must be
# ---------------------------------------------------------------------------

# the functional collectives (the ops DTensor and the port call), by the
# name the probe reports them under
FUNCTIONAL = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
              "all_to_all_single", "broadcast")
# point-to-point (the pipeline's ring): staged in the caller
P2P = "batch_isend_irecv"
PROBED = FUNCTIONAL + (P2P,)
_staged: set = set()


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _host_collective(name: str, x: torch.Tensor, *args) -> torch.Tensor:
    """The functional collective ``name`` on a host copy of ``x``, run by
    gloo's CPU path, its result returned on ``x``'s device."""
    import torch.distributed._functional_collectives as funcol
    group = args[-1]
    h = _host(x.contiguous())
    if name == "all_gather_into_tensor":
        y = funcol.all_gather_tensor(h, 0, group)
    elif name == "reduce_scatter_tensor":
        y = funcol.reduce_scatter_tensor(h, args[0], 0, group)
    elif name == "all_reduce":
        y = funcol.all_reduce(h, args[0], group)
    elif name == "all_to_all_single":
        y = funcol.all_to_all_single(h, args[0], args[1], group)
    else:                                              # broadcast
        y = funcol.broadcast(h, args[0], group)
    return funcol.wait_tensor(y).to(x.device)


def stage_through_host(names: Sequence[str]) -> None:
    """Route the functional collectives ``names`` on CUDA tensors through
    pinned host memory (for this process). The CUDA kernels of those ops
    are replaced; every other collective keeps gloo's own CUDA path."""
    lib = torch.library.Library("_c10d_functional", "IMPL")
    _state.staging_lib = lib                # alive as long as the process
    for name in names:
        if name == P2P:
            _staged.add(name)
            continue
        if name not in FUNCTIONAL:
            raise ValueError(f"no host staging for {name!r}")

        def kernel(x, *args, _name=name):
            if _name == "all_gather_into_tensor":      # (x, size, group)
                return _host_collective(_name, x, args[1])
            return _host_collective(_name, x, *args)
        lib.impl(name, kernel, "CUDA")
        _staged.add(name)


def staged_collectives() -> List[str]:
    return sorted(_staged)


def _probe_rank(rank: int, name: str):
    """One collective on CUDA tensors through gloo, checked against its
    expected value."""
    import torch.distributed._functional_collectives as funcol
    n, g = dist.get_world_size(), dist.group.WORLD
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_gather_into_tensor":
        y = funcol.all_gather_tensor(x, 0, g)
        want = torch.arange(1, n + 1, device=dev).repeat_interleave(4)
    elif name == "reduce_scatter_tensor":
        y = funcol.reduce_scatter_tensor(torch.ones(2 * n, device=dev) * (rank + 1),
                                         "sum", 0, g)
        want = torch.full((2,), n * (n + 1) / 2, device=dev)
    elif name == "all_reduce":
        y = funcol.all_reduce(x, "max", g)
        want = torch.full((4,), float(n), device=dev)
    elif name == "all_to_all_single":
        src = torch.arange(n, device=dev, dtype=torch.float32) + 10 * rank
        ins = [1] * n
        y = funcol.all_to_all_single(src, ins, ins, g)
        want = torch.tensor([rank + 10.0 * j for j in range(n)], device=dev)
    elif name == "broadcast":
        y = funcol.broadcast(x, 1, g)
        want = torch.full((4,), 2.0, device=dev)
    else:                                              # batch_isend_irecv
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % n),
               dist.P2POp(dist.irecv, y, (rank - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        want = torch.full((4,), float((rank - 1) % n + 1), device=dev)
    y = funcol.wait_tensor(y) if name != P2P else y
    torch.cuda.synchronize()
    return bool(torch.equal(y, want))


def probe_gloo_cuda(world: int = 2, timeout: float = 120.0) -> Dict[str, str]:
    """Which collectives gloo runs on CUDA tensors of ranks sharing a card:
    each is tried by ``world`` ranks in a process group of its own (an
    unsupported one may abort its processes), all probes at once.
    Returns ``{name: "ok" | what went wrong}``."""
    import concurrent.futures as cf
    out = {}
    with cf.ThreadPoolExecutor(len(PROBED)) as pool:
        futs = {name: pool.submit(spawn, _probe_rank, world, name,
                                  device="cuda", backend="gloo",
                                  timeout=timeout)
                for name in PROBED}
        for name, fut in futs.items():
            try:
                ok = all(fut.result())
                out[name] = "ok" if ok else "wrong values"
            except Exception as e:                  # noqa: BLE001 — reported
                out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def group_device_type() -> str:
    """The device type the running ranks compute on (``cpu`` unless
    :func:`init_ranks` gave them a card)."""
    return getattr(_state, "device_type", None) or "cpu"


def close_ranks() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.device_type = None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, backend, staged, threads,
               args, q):
    torch.set_num_threads(threads)
    try:
        init_ranks(rank, world, port, device=device, backend=backend,
                   staged=staged)
        q.put((rank, True, fn(rank, *args)))
    except BaseException:                     # noqa: BLE001 — sent to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        close_ranks()


def spawn(fn: Callable, world: int, *args: Any, device: str = "cpu",
          backend: Optional[str] = None, staged: Sequence[str] = (),
          timeout: float = 600.0, threads: int = 1) -> List[Any]:
    """``fn(rank, *args)`` on ``world`` fresh processes that form one
    process group (:func:`init_ranks`, ``threads`` intra-op threads each);
    returns the results by rank (picklable values). A rank's exception is
    raised here with its traceback, a rank that dies or hangs as a
    ``TimeoutError``; no process outlives the call."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, device, backend,
                               tuple(staged), threads, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, val = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode})") from None
                if time.monotonic() > end:
                    raise TimeoutError(f"{world - len(results)} of {world} "
                                       f"ranks gave no result in {timeout} s"
                                       ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
