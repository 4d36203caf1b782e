"""Client process groups and the data × model grid of ranks (port of
``repro/launch/mesh.py``).

The reference lays devices on a ('data', 'model') mesh: the federated
clients on the 'data' axes, one client a shard, and each client's
backbone split over 'model' by tensor parallelism.  Here each device is
one process, a rank of a ``torch.distributed`` group:

  make_client_mesh(C)  the client group (``ClientGroup``) of this
                       process: ``rank``, ``size`` and its collectives
                       (``all_reduce`` and ``all_gather`` of a list of
                       tensors, ``reduce_max``, ``exchange``: the
                       all-to-all)
  make_debug_mesh(n_data, n_model)
                       this process's place on a grid of n_data × n_model
                       ranks (``Grid``): rank r = d · n_model + m sits at
                       data index d and model index m; ``grid.data`` is
                       the group of its data column (the ranks with its
                       model index: the clients, and the expert-parallel
                       all-to-all), ``grid.model`` the group of its model
                       row (the ranks that split one client's backbone)
  make_production_mesh(n_data=, n_model=)
                       the same over the node's cards, rank r on card
                       r mod ``torch.cuda.device_count()``
  make_meta_grid(n_data, n_model, rank=0)
                       one rank's place on such a grid with no processes,
                       on ``device="meta"``: its groups (``MetaGroup``)
                       make the real groups' buffers and count their
                       bytes, and send nothing (the dry run on a grid)
  AbstractGrid         a grid's axes and shape with no processes, for the
                       sharding rules (``utils/sharding.py``,
                       ``launch/specs.py``)
  data_axes(mesh)      the group the clients are enumerated over (the
                       client mesh itself, a grid's data column)
  dp_size(mesh)        its size C
  ClientPool           the ranks, started once (``spawn``), each in the
                       group or on the grid, running the tasks it is given
                       and returning each rank's result or its traceback

A grid's ranks run on the card (``device="cuda"``, the default of
``make_debug_mesh`` and ``ClientPool``) unless the caller asks for the
CPU (``device="cpu"``, as the tests do).  Backend, chosen by the layout:
NCCL where every rank has a card of its own (``n_data · n_model <=
torch.cuda.device_count()``, ranks on the card), gloo where ranks share
a card (NCCL refuses two ranks on one device) or run on the CPU.  gloo runs ``all_reduce``, ``all_gather``
and ``all_to_all_single`` on CUDA tensors, but not the list form of
``all_to_all`` (probed on an H100 80GB HBM3 at 700 W: "Backend gloo does
not support alltoall"), so the exchange is ``all_to_all_single``.  Every
collective is issued on the buffer as it is, and a failure raises: no
path moves to the host or to another backend.

Rendezvous is a file (``init_method="file://..."``) in a directory the
caller gives, so that two pools (parallel test workers) never share a
port.  With one client no process group is needed: ``make_client_mesh
(1)`` outside a group is a group of one whose collectives are the
identity.

Not ported: ``shard_map_compat`` (there is no ``shard_map``: each rank
runs its own shard's program and the layers issue the collectives,
``utils/collectives.py``) and the 'pod' axis (one node; ``multi_pod``
raises).
"""
from __future__ import annotations

import copy
import datetime
import math
import os
import time
import traceback
import uuid

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "all_gather", "all_to_all")
RANK_THREADS = 1        # a rank's intra-op CPU threads: C ranks share a host
GRACE_S = 10.0          # how long the others may run on once a rank failed


def init_client_group(n_clients: int, rank: int, init_file: str, *,
                      timeout_s: float = 300.0, backend: str = "gloo") -> None:
    """Join this process to a group of ``n_clients`` ranks (a client
    group, or a grid's world), rendezvous through ``init_file`` (which
    must not exist before the first rank joins)."""
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        world_size=n_clients, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def grid_backend(world: int, device="cuda") -> str:
    """NCCL when the ranks run on cards and each has one of its own,
    else gloo (ranks that share a card, or run on the CPU)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


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

    _clock = staticmethod(time.perf_counter)

    def _collective(self, op, buf, fn):
        """Run ``fn`` on ``buf`` where it lies and count the call."""
        st = self.stats[op]
        t0 = self._clock()
        out = fn(buf)
        st["calls"] += 1
        st["bytes"] += buf.numel() * buf.element_size()
        st["seconds"] += self._clock() - t0
        return out

    # the communication itself, on buffers the methods below make: a
    # meta group (``MetaGroup``) replaces these three and nothing else
    def _all_reduce_(self, b, op=dist.ReduceOp.SUM):
        dist.all_reduce(b, op=op, group=self.pg)

    def _all_gather_(self, parts, b):
        dist.all_gather(parts, b, group=self.pg)

    def _all_to_all_(self, out, b):
        dist.all_to_all_single(out, b, group=self.pg)

    def all_reduce(self, tensors: list) -> list:
        """[Σ over ranks of t for t in tensors], in one all-reduce a
        dtype."""
        if self.size == 1:
            return [t.clone() for t in tensors]
        out = [None] * len(tensors)
        for buf, idx in self._flat(tensors).values():
            def reduce(b):          # b is a fresh buffer (torch.cat)
                self._all_reduce_(b)
                return b
            red = self._collective("all_reduce", buf, reduce)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = red[off:off + n].reshape(tensors[i].shape)
                off += n
        return out

    def reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks of ``t``, a new tensor."""
        if self.size == 1:
            return t.clone()
        buf = t.contiguous().clone()

        def reduce(b):
            self._all_reduce_(b, dist.ReduceOp.MAX)
            return b
        return self._collective("all_reduce", buf, reduce)

    def exchange(self, t: torch.Tensor) -> torch.Tensor:
        """The all-to-all: ``t``'s dim 0 cut into ``size`` equal chunks,
        chunk j sent to rank j; the result's chunk i is what rank i sent
        here (``all_to_all_single``)."""
        if self.size == 1:
            return t.clone()
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split over {self.size} ranks")
        buf = t.contiguous()

        def exchange(b):
            out = torch.empty_like(b)
            self._all_to_all_(out, b)
            return out
        return self._collective("all_to_all", buf, exchange)

    def all_gather(self, tensors: list) -> list:
        """[every rank's t stacked in rank order, (C, *t.shape)], in one
        all-gather a dtype."""
        if self.size == 1:
            return [t[None].clone() for t in tensors]
        out = [None] * len(tensors)
        for buf, idx in self._flat(tensors).values():
            def gather(b):
                parts = [torch.empty_like(b) for _ in range(self.size)]
                self._all_gather_(parts, b)
                return torch.stack(parts)
            got = self._collective("all_gather", buf, gather)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = got[:, off:off + n].reshape(
                    (self.size,) + tuple(tensors[i].shape))
                off += n
        return out


class MetaGroup(ClientGroup):
    """A group of ``size`` ranks with no processes behind it, for a step
    run on ``device="meta"`` tensors (the dry run on a grid,
    ``launch/dryrun.py``): every collective makes the buffers and returns
    the outputs the real group's makes (the same ``torch.cat`` buffers,
    ``empty_like`` parts, stack and clone), so a storage tally sees the
    same allocations, and counts ``stats`` the same way (calls, the
    bytes this rank sends once); only the communication is left out, and
    the seconds are 0."""

    _clock = staticmethod(lambda: 0.0)

    def _all_reduce_(self, b, op=None):
        pass

    def _all_gather_(self, parts, b):
        pass

    def _all_to_all_(self, out, b):
        pass


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


class AbstractGrid:
    """A grid's axes and shape, with no processes behind it: what the
    sharding rules read (``axis_names``, ``shape``), and optionally one
    rank's place on it (``coords``: axis → index) for ``launch/specs
    .shard_tree``."""

    def __init__(self, shape, axis_names=("data", "model"), coords=None):
        if not isinstance(shape, dict):
            shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.coords = dict(coords) if coords else None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return (f"{type(self).__name__}({self.shape}"
                + (f", at {self.coords}" if self.coords else "") + ")")


class Grid(AbstractGrid):
    """This rank's place on a data × model grid of ranks: ``rank``,
    ``coords`` {"data": d, "model": m}, the groups ``data`` (its data
    column: C = n_data ranks, the clients) and ``model`` (its model row:
    the n_model ranks that split one backbone), the ``backend`` and the
    rank's ``device``.

    Modes, each set on a copy by ``replace``:

      rows_split    how a served batch lies on the data axis: its rows
                    split over the data ranks (True, the default), or the
                    same rows on every data rank (False: a batch that
                    does not divide, the reference's small-batch path);
                    ``launch/serve.py`` sets it
      manual        the production engine's grid (``launch/train.py``
                    sets it): each data rank is a client of its own, and
                    MoE runs ``layers.moe_ffn_manual`` (else
                    ``moe_ffn_ep``)
      seq_shard_kv  the decode cache's kv split on its sequence over the
                    model row where the reference's rule splits it
                    (``launch/specs.cache_specs(seq_shard_kv=True)``: the
                    rows split over the data ranks, kv heads that do not
                    divide over the model ranks, a length that does);
                    False (the default): kv heads split where they
                    divide, else whole.  The caller sets it
      kv_len        with ``seq_shard_kv``, the whole decode cache's
                    positions (a global layer's slots), which tell a
                    decode step which of its caches are split
                    (``launch/serve.greedy_generate`` sets it from its
                    cache length; a prefill needs none)"""

    def __init__(self, n_data, n_model, rank, data: ClientGroup,
                 model: ClientGroup, backend: str, device):
        super().__init__((n_data, n_model), ("data", "model"),
                         {"data": rank // n_model, "model": rank % n_model})
        self.rank, self.data, self.model = rank, data, model
        self.backend, self.device = backend, torch.device(device)
        self.rows_split, self.manual = True, False
        self.seq_shard_kv, self.kv_len = False, 0

    def replace(self, *, rows_split: bool | None = None,
                manual: bool | None = None,
                seq_shard_kv: bool | None = None,
                kv_len: int | None = None) -> "Grid":
        """A copy with the modes given set (the groups are shared)."""
        out = copy.copy(self)
        if rows_split is not None:
            out.rows_split = bool(rows_split)
        if manual is not None:
            out.manual = bool(manual)
        if seq_shard_kv is not None:
            out.seq_shard_kv = bool(seq_shard_kv)
        if kv_len is not None:
            out.kv_len = int(kv_len)
        return out

    @property
    def stats(self) -> dict:
        """The collectives' calls, bytes and seconds, per group."""
        return {"data": self.data.stats, "model": self.model.stats}


def _grid(n_data: int, n_model: int, device) -> Grid:
    """This process's Grid over the initialized process group: one
    subgroup a data column and one a model row, made by every rank in
    the same order (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a grid of {n_data} x {n_model} needs torch.distributed: run "
            "it in a ClientPool rank (or call init_client_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_model:
        raise ValueError(f"the process group has {world} ranks, not "
                         f"{n_data} x {n_model}")
    cols = [dist.new_group([d * n_model + m for d in range(n_data)])
            for m in range(n_model)]
    rows = [dist.new_group([d * n_model + m for m in range(n_model)])
            for d in range(n_data)]
    d, m = rank // n_model, rank % n_model
    return Grid(n_data, n_model, rank, ClientGroup(d, n_data, cols[m]),
                ClientGroup(m, n_model, rows[d]), dist.get_backend(), device)


def make_debug_mesh(n_data: int = 4, n_model: int = 2, *,
                    multi_pod: bool = False, device="cuda") -> Grid:
    """This rank's Grid of ``n_data`` × ``n_model`` ranks (the reference's
    small CI mesh) on ``device``: "cuda" (the default) for the card r mod
    ``torch.cuda.device_count()``, made current, or "cpu" when the
    caller asks for it."""
    if multi_pod:
        raise ValueError("multi_pod: one node has no 'pod' axis")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return _grid(n_data, n_model, dev)


def make_production_mesh(*, n_data: int, n_model: int,
                         multi_pod: bool = False) -> Grid:
    """This rank's Grid over the node's cards: rank r on card r mod
    ``torch.cuda.device_count()``.  (The reference's is a TPU pod slice
    of 16 × 16 chips; one node's grid is the size of its process group.)
    ``multi_pod`` raises: one node has no 'pod' axis."""
    return make_debug_mesh(n_data, n_model, multi_pod=multi_pod,
                           device="cuda")


def make_meta_grid(n_data: int, n_model: int, rank: int = 0) -> Grid:
    """Rank ``rank``'s Grid of ``n_data`` × ``n_model`` ranks on
    ``device="meta"``, its groups ``MetaGroup``s: what a step on a grid
    allocates and sends on one rank, with no processes and no storage
    (the dry run on a grid)."""
    if not 0 <= rank < n_data * n_model:
        raise ValueError(f"rank {rank} is not on a {n_data} x {n_model} grid")
    d, m = rank // n_model, rank % n_model
    return Grid(n_data, n_model, rank, MetaGroup(d, n_data),
                MetaGroup(m, n_model), "meta", "meta")


def data_axes(mesh):
    """The group the clients are enumerated over: a client mesh itself,
    or a grid's data column."""
    return mesh.data if isinstance(mesh, Grid) else mesh


def dp_size(mesh) -> int:
    return data_axes(mesh).size


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------

def _rank_main(rank, n_clients, n_model, device, init_file, timeout_s,
               conn):
    """A pool rank: join the group (or the grid), then run tasks until
    told to stop."""
    torch.set_num_threads(RANK_THREADS)
    try:
        if n_model is None:
            init_client_group(n_clients, rank, init_file, timeout_s=timeout_s)
            group = make_client_mesh(n_clients)
        else:
            world = n_clients * n_model
            backend = grid_backend(world, device)
            if backend == "nccl":       # a card of its own before the init
                torch.cuda.set_device(rank % torch.cuda.device_count())
            init_client_group(world, rank, init_file, timeout_s=timeout_s,
                              backend=backend)
            group = make_debug_mesh(n_clients, n_model, device=device)
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
        # drop the arguments now, not at the next task: a CUDA tensor the
        # caller sent is its memory, mapped here, which it cannot free
        # while a rank holds it
        del task, fn, args, kwargs
        try:
            conn.send(out)
        except Exception:       # a result that does not pickle
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


class ClientPool:
    """``n_clients`` rank processes of one client group, started once; or,
    with ``n_model``, the n_clients × n_model ranks of a grid, each task
    given the rank's ``Grid`` (``make_debug_mesh`` on ``device``: the
    card unless the caller asks for "cpu"; the backend by
    ``grid_backend``).  A client group's ranks place their own tensors,
    and ignore ``device``.

    ``run(fn, *args, **kwargs)`` calls ``fn(group, *args, **kwargs)`` on
    every rank (``group``: the rank's ``ClientGroup`` or ``Grid``) and
    returns the results in rank order; if a rank raises, ``run`` raises a
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
                 timeout_s: float = 300.0, n_model: int | None = None,
                 device="cuda"):
        self.clients, self.n_model, self.device = n_clients, n_model, device
        self.n = n_clients * (n_model or 1)
        self.workdir, self.timeout_s = workdir, timeout_s
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
                            args=(r, self.clients, self.n_model, self.device,
                                  init_file, self.timeout_s, child))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._collect(self.timeout_s, "joining the client group"
                      if self.n_model is None else "joining the grid")

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

