"""Client process groups for the production round engine (port of
``repro/launch/mesh.py``).

The reference lays the federated clients on the 'data' axes of a device
mesh, one client a shard, and runs a round inside a ``shard_map`` that
is manual over them.  Here each client is one process, a rank of a
``torch.distributed`` group of world size C:

  make_client_mesh(C)  the client group (``ClientGroup``) of this
                       process: ``rank``, ``size`` and the collectives
                       the engine issues (``all_reduce``, ``all_gather``)
  data_axes(mesh)      the group the clients are enumerated over (the
                       mesh itself)
  dp_size(mesh)        its world size C
  ClientPool           C rank processes, started once (``spawn``), each
                       in the group, running the tasks it is given and
                       returning each rank's result or its traceback

Backend: gloo, on the card too.  NCCL refuses two ranks on one device,
and the card is one H100.  gloo runs both of the engine's collectives,
``all_reduce`` and ``all_gather``, on CUDA tensors (measured on an H100
80GB HBM3 at 700 W by ``chip_smoke.py`` phase 12), so every collective
is issued on the buffer as it is and a failure raises.  The payload is
the adapter tree (a few MB at llama2-7b width), never activations or the
backbone.

Rendezvous is a file (``init_method="file://..."``) in a directory the
caller gives, so that two pools (parallel test workers) never share a
port.  With one client no process group is needed: ``make_client_mesh
(1)`` outside a group is a group of one whose collectives are the
identity.

Not ported: ``make_production_mesh`` (a TPU pod slice), the 'model' axis
of ``make_debug_mesh``, ``shard_map_compat`` and ``utils/sharding.py``.
One card has no tensor-parallel axis, every rank holds whole tensors,
and nothing here is a ``shard_map``.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
import uuid

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "all_gather")
RANK_THREADS = 1        # a rank's intra-op CPU threads: C ranks share a host
GRACE_S = 10.0          # how long the others may run on once a rank failed


def init_client_group(n_clients: int, rank: int, init_file: str, *,
                      timeout_s: float = 300.0) -> None:
    """Join this process to the client group: gloo, rendezvous through
    ``init_file`` (which must not exist before the first rank joins)."""
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.abspath(init_file)}",
        world_size=n_clients, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


class ClientGroup:
    """One client's view of the client group: ``rank`` (its client
    index), ``size`` (C) and the engine's collectives, each over a list
    of tensors on one device.  ``stats[op]`` counts calls, payload bytes
    (what this rank sends, once) and wall seconds."""

    def __init__(self, rank: int, size: int, pg=None):
        self.rank, self.size, self.pg = rank, size, pg
        self.stats = {op: {"calls": 0, "bytes": 0, "seconds": 0.0}
                      for op in COLLECTIVES}

    def _flat(self, tensors):
        """One flat buffer per dtype: {dtype: (buffer, [indices])}."""
        groups: dict = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        return {dt: (torch.cat([tensors[i].reshape(-1) for i in idx]), idx)
                for dt, idx in groups.items()}

    def _collective(self, op, buf, fn):
        """Run ``fn`` on ``buf`` where it lies and count the call."""
        st = self.stats[op]
        t0 = time.perf_counter()
        out = fn(buf)
        st["calls"] += 1
        st["bytes"] += buf.numel() * buf.element_size()
        st["seconds"] += time.perf_counter() - t0
        return out

    def all_reduce(self, tensors: list) -> list:
        """[Σ over ranks of t for t in tensors], in one all-reduce a
        dtype."""
        if self.size == 1:
            return [t.clone() for t in tensors]
        out = [None] * len(tensors)
        for buf, idx in self._flat(tensors).values():
            def reduce(b):          # b is a fresh buffer (torch.cat)
                dist.all_reduce(b, group=self.pg)
                return b
            red = self._collective("all_reduce", buf, reduce)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = red[off:off + n].reshape(tensors[i].shape)
                off += n
        return out

    def all_gather(self, tensors: list) -> list:
        """[every rank's t stacked in rank order, (C, *t.shape)], in one
        all-gather a dtype."""
        if self.size == 1:
            return [t[None].clone() for t in tensors]
        out = [None] * len(tensors)
        for buf, idx in self._flat(tensors).values():
            def gather(b):
                parts = [torch.empty_like(b) for _ in range(self.size)]
                dist.all_gather(parts, b, group=self.pg)
                return torch.stack(parts)
            got = self._collective("all_gather", buf, gather)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = got[:, off:off + n].reshape(
                    (self.size,) + tuple(tensors[i].shape))
                off += n
        return out


def make_client_mesh(n_clients: int) -> ClientGroup:
    """This process's client group of ``n_clients`` ranks, one client a
    rank (the reference's data-only mesh, one client a shard).  Needs a
    process group of that size (``init_client_group``, or a
    ``ClientPool`` rank), except for one client."""
    if not dist.is_initialized():
        if n_clients != 1:
            raise RuntimeError(
                f"a client group of {n_clients} needs torch.distributed: "
                "run it in a ClientPool rank (or call init_client_group)")
        return ClientGroup(0, 1)
    size = dist.get_world_size()
    if size != n_clients:
        raise ValueError(f"the process group has {size} ranks, not "
                         f"{n_clients} clients")
    return ClientGroup(dist.get_rank(), size)


def data_axes(mesh: ClientGroup) -> ClientGroup:
    """The group the clients are enumerated over: the mesh itself."""
    return mesh


def dp_size(mesh: ClientGroup) -> int:
    return mesh.size


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------

def _rank_main(rank, n_clients, init_file, timeout_s, conn):
    """A pool rank: join the group, then run tasks until told to stop."""
    torch.set_num_threads(RANK_THREADS)
    try:
        init_client_group(n_clients, rank, init_file, timeout_s=timeout_s)
        group = make_client_mesh(n_clients)
        conn.send((True, None))
    except Exception:
        conn.send((False, traceback.format_exc()))
        return
    while True:
        task = conn.recv()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            out = (True, fn(group, *args, **kwargs))
        except Exception:
            out = (False, traceback.format_exc())
        try:
            conn.send(out)
        except Exception:       # a result that does not pickle
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


class ClientPool:
    """``n_clients`` rank processes of one client group, started once.

    ``run(fn, *args, **kwargs)`` calls ``fn(group, *args, **kwargs)`` on
    every rank (``group``: the rank's ``ClientGroup``) and returns the
    results in rank order; if a rank raises, ``run`` raises a
    RuntimeError carrying that rank's traceback, and stops the pool when
    a rank died or the others do not finish within GRACE_S (they may
    wait in a collective the failed rank never reached); the next
    ``run`` then starts a fresh pool.  ``fn`` and its arguments travel
    by pickle (``torch.multiprocessing``: CPU tensors through shared
    memory, CUDA tensors by CUDA IPC, mapped by the ranks and not
    copied; they must outlive the call, and the ranks must not write
    them).  ``fn`` must be importable by name; its result travels back
    the same way.

    ``workdir`` holds the rendezvous file; ``timeout_s`` bounds a call
    and each collective."""

    def __init__(self, n_clients: int, workdir: str, *,
                 timeout_s: float = 300.0):
        self.n, self.workdir, self.timeout_s = n_clients, workdir, timeout_s
        self._procs: list = []
        self._conns: list = []
        self._start()

    def _start(self):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        os.makedirs(self.workdir, exist_ok=True)
        init_file = os.path.join(self.workdir,
                                 f"rendezvous-{uuid.uuid4().hex}")
        for r in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, self.n, init_file, self.timeout_s,
                                  child))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._collect(self.timeout_s, "joining the client group")

    def _collect(self, timeout_s, what):
        results: dict = {}
        failed: dict = {}
        deadline, first_fail = time.monotonic() + timeout_s, None
        while len(results) + len(failed) < self.n:
            now = time.monotonic()
            if now > deadline or (first_fail is not None
                                  and now > first_fail + GRACE_S):
                break
            for r, (p, c) in enumerate(zip(self._procs, self._conns)):
                if r in results or r in failed:
                    continue
                if c.poll(0.02):
                    try:
                        ok, out = c.recv()
                    except EOFError:
                        ok, out = False, f"rank {r} exited (code {p.exitcode})"
                    if ok:
                        results[r] = out
                        continue
                elif not p.is_alive():
                    out = f"rank {r} died (exit code {p.exitcode})"
                else:
                    continue
                first_fail = first_fail or time.monotonic()
                failed[r] = out
        if len(results) == self.n:
            return [results[r] for r in range(self.n)]
        missing = [r for r in range(self.n) if r not in results
                   and r not in failed]
        if missing or any(not p.is_alive() for p in self._procs):
            self.close(force=True)
        msg = [f"client pool, {what}:"]
        msg += [f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())]
        if missing:
            msg.append(f"ranks {missing} did not finish (stopped)")
        raise RuntimeError("\n".join(msg))

    def run(self, fn, *args, **kwargs):
        if not self._procs:
            self._start()
        for c in self._conns:
            c.send((fn, args, kwargs))
        return self._collect(self.timeout_s, getattr(fn, "__name__",
                                                     repr(fn)))

    def close(self, force: bool = False) -> None:
        for p, c in zip(self._procs, self._conns):
            if not force and p.is_alive():
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

