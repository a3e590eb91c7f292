"""Concurrent multi-job schedule-construction service.

The paper's online component (§5) enforces schedule orders computed per
job at submission.  Every arrival's construction is independent — each
job owns its own DAG, ``Space`` and ``ConstructionMemo`` — yet a serial
simulator runs them one after another inside the arrival event, and on the
port's exact path that build phase is most of the wall time.  This module
overlaps them.

Three pieces:

  * a **content-digest dedup front** — submissions are keyed by the
    canonical ``core.dag.dag_digest`` plus every ``build_schedule`` knob,
    so equal-content jobs (recurring pipelines, replayed populations)
    share one construction, and completed entries double as a bounded
    result cache;
  * a **worker pool** — ``mode="process"`` (the default for more than one
    worker) fans builds out to worker processes; ``mode="thread"`` shares
    the interpreter; ``mode="serial"`` degenerates to an inline loop.
    Processes are the default because the builder is *Python-bound* at
    online grid sizes (m≈4): its heap walk, anchors and memo bookkeeping
    hold the interpreter lock around each short scan;
  * a **submit/future API** — ``submit`` returns a ``BuildHandle``
    immediately; ``build_many`` is the gather form.  The cluster
    simulator submits every arrival's DAG at run start and the event
    loop consumes completed orders as jobs arrive.

Determinism: ``build_schedule`` is a pure function of (DAG content, m,
knobs), and by the scan's exactness contract (``core/engine/kernels.py``)
of neither the device nor the kernel implementation — the pool changes
*when and where* a schedule is computed, never its bits, so scheduling
decisions downstream are bit-identical to a serial loop.

Processes and the card.  The parent of a pool holds threads (the shard
executor's, the retry timers') and, once any op ran on the card, a CUDA
context; neither survives a ``fork``.  Workers therefore start by
**forkserver** — forked from a clean server process that was exec'd and
preloaded the builder stack (importing torch starts no CUDA context) — or
by **spawn** where the platform has none.  Both re-import the parent's
``__main__`` in each worker; a heredoc/stdin parent, which cannot be
re-imported, may fork only while it holds no CUDA context and no second
thread, and ``fork`` (asked for with ``REPRO_BUILD_MP=fork`` or not)
raises otherwise.  Each worker is a process with its own CUDA context, its
own scan stage and stream (``kernels/placement_scan/kernel.py``
``thread_stage``).  What the parent has in force reaches it explicitly,
at pool creation, through the pool's initializer, never through
inheritance (a forkserver's environment is frozen when the server
starts): the fault plan, the ``REPRO_*`` settings (kernel pins, backend,
memo) and the torch thread count; and, with every build, the service's
``device``, which goes to ``build_schedule(device=...)``.  The parent
builds the placement-scan library before the first pool starts, so workers
load the built ``.so`` and never run ``nvcc``.

Recovery (``faults.RecoveryPolicy``): an injected ``build_worker`` fault, a
dead worker (``BrokenExecutor``) and a cancelled attempt are retried with
backoff, crash-looping digests are quarantined, and the last resort builds
inline on the parent; any other exception of a worker (a CUDA error, a
refused launch) completes the handle with that exception — there is no
fallback that would hide the device.

Process workers ship a slim result tuple (order/start/machine/span —
not the Schedule, whose ``dag`` back-reference would re-pickle the whole
DAG); the parent rebinds it to its own DAG object.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import (BrokenExecutor, Future, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from typing import Sequence

from . import faults
from .builder import Schedule, build_schedule
from .dag import DAG, dag_digest
from .engine import get_backend, kernels

#: env defaults: worker count and pool mode (serial | thread | process)
WORKERS_ENV = "REPRO_BUILD_WORKERS"
MODE_ENV = "REPRO_BUILD_MODE"
#: multiprocessing start method for process mode (forkserver | spawn | fork)
MP_ENV = "REPRO_BUILD_MP"

MODES = ("serial", "thread", "process")

#: modules a forkserver imports once, before it forks any worker: the
#: builder stack and torch with the scan's kernel modules, which the
#: builder imports only at its first scan (importing torch starts no CUDA
#: context; without it every worker would pay torch's import itself)
PRELOAD = ["torch", "repro_torch.core.builder", "repro_torch.core.buildsvc",
           "repro_torch.core.engine.jit",
           "repro_torch.kernels.placement_scan.kernel",
           "repro_torch.kernels.placement_scan.ops"]


def default_workers() -> int:
    """REPRO_BUILD_WORKERS, else the host's CPU count."""
    env = os.environ.get(WORKERS_ENV)
    if env:
        return max(int(env), 1)
    return max(os.cpu_count() or 1, 1)


def _main_survives_reimport() -> bool:
    """Whether forkserver children can re-prepare ``__main__``.

    Their preparation step re-imports the parent's main module (as
    ``__mp_main__``); a heredoc/stdin parent has ``__file__ == '<stdin>'``
    which no child can open.
    """
    main = sys.modules.get("__main__")
    if main is None or getattr(main, "__spec__", None) is not None:
        return True                      # python -m ...: import by name
    f = getattr(main, "__file__", None)
    return f is None or os.path.exists(f)


def _fork_hazards() -> list[str]:
    """What makes ``fork`` unsafe in this process right now."""
    import torch

    out = []
    if torch.cuda.is_initialized():
        out.append("a CUDA context")
    if threading.active_count() > 1:
        out.append(f"{threading.active_count() - 1} thread(s) besides the "
                   "main one")
    return out


def _default_mp_context():
    """Start method for process-mode workers (REPRO_BUILD_MP overrides).

    **forkserver**, preloading the builder stack, else **spawn** where the
    platform has no forkserver.  Both prepare each worker by re-importing
    the parent's main module, which a heredoc/stdin parent does not have
    on disk: such a parent gets **fork** if it holds neither a CUDA context
    nor a thread besides the main one, and an error otherwise.  **fork**,
    asked for or not, raises when the parent holds either (a forked child
    would inherit a context it cannot use, or a lock some other thread
    held).
    """
    name = os.environ.get(MP_ENV)
    if not name:
        methods = multiprocessing.get_all_start_methods()
        if not _main_survives_reimport():
            name = "fork"
        elif "forkserver" in methods:
            name = "forkserver"
        else:  # pragma: no cover - non-posix platforms
            name = "spawn"
    if name == "fork":
        hazards = _fork_hazards()
        if hazards:
            raise RuntimeError(
                f"fork refused for build workers: this process holds "
                f"{' and '.join(hazards)}, which a forked worker cannot "
                "inherit safely; use forkserver or spawn (from a parent "
                "whose __main__ is a file or a module) or thread mode")
    ctx = multiprocessing.get_context(name)
    if name == "forkserver":
        ctx.set_forkserver_preload(PRELOAD)
    return ctx


def stop_forkserver() -> None:
    """Stop this process's forkserver, the server the process pools fork
    their workers from.  It exits with this process anyway; a script that
    must leave no process running stops it first.  A later pool starts a
    new one."""
    from multiprocessing import forkserver

    stop = getattr(forkserver._forkserver, "_stop", None)
    if stop is not None:
        stop()


# ----------------------------------------------------------------------
# worker side
# ----------------------------------------------------------------------

def _repro_env() -> dict[str, str]:
    """This process's ``REPRO_*`` settings (kernel pins, backend, memo...)."""
    return {k: v for k, v in os.environ.items() if k.startswith("REPRO_")}


def _init_worker(plan_spec: str, n_threads: int, env: dict) -> None:
    """Process-pool initializer.  A forkserver's environment was frozen
    when the server started, so the parent's state as of pool creation
    comes here explicitly: its ``REPRO_*`` settings (``env``, replacing the
    worker's own), the fault plan in force (its spec; '' for none) and its
    torch thread count."""
    import torch

    torch.set_num_threads(max(int(n_threads), 1))
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[k]
    os.environ.update(env)
    faults.install(plan_spec or None)
    if not plan_spec:
        os.environ.pop(faults.FAULTS_ENV, None)


def _build_slim(dag: DAG, m: int, kw: dict, device: str,
                fault_key: tuple | None = None) -> tuple:
    """One build on ``device``, returned as the slim tuple BuildHandle
    rebinds.

    Module-level so process pools can pickle it; also the single code
    path for every mode (serial/thread pools call it too), keeping the
    three modes trivially output-identical.

    ``fault_key = (digest_hex, attempt)`` is set only on *pool* attempts:
    it arms the ``build_worker`` injection seam.  Inline/serial builds
    never inject — they are the trusted final resort of the retry policy.
    """
    if fault_key is not None:
        faults.maybe_fail("build_worker", digest=fault_key[0],
                          attempt=fault_key[1])
    s = build_schedule(dag, m, device=device, **kw)
    return (s.order, s.start, s.machine, float(s.makespan), float(s.tick),
            s.trouble_mask, s.label, s.build_info)


class BuildHandle:
    """Future-like view of one submitted build.

    Deduplicated submissions share the underlying future but keep their
    own DAG object, so ``result()`` hands every caller a ``Schedule``
    bound to the DAG instance it submitted.
    """

    __slots__ = ("_future", "_dag", "key")

    def __init__(self, future: Future, dag: DAG, key: tuple):
        self._future = future
        self._dag = dag
        self.key = key

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None) -> Schedule:
        order, start, machine, makespan, tick, tmask, label, info = \
            self._future.result(timeout)
        return Schedule(dag=self._dag, order=order, start=start,
                        machine=machine, makespan=makespan, tick=tick,
                        trouble_mask=tmask, label=label, build_info=info)


# knobs of build_schedule that participate in the dedup key, with the
# defaults mirrored from its signature
_KNOB_DEFAULTS = {
    "ticks": 256,
    "n_long": 8,
    "n_frag": 6,
    "max_candidates": 24,
    "use_partitions": True,
}


def _complete(out: Future, result=None, exc=None) -> None:
    """Complete a supervised future, tolerating a lost shutdown race
    (already cancelled / already completed)."""
    try:
        if exc is not None:
            out.set_exception(exc)
        elif not out.done():
            out.set_result(result)
    except Exception:
        pass


def _stop_workers(procs: list, grace: float = 1.0) -> None:
    """Reap a shut-down process pool's workers (``procs``, taken before the
    shutdown, which forgets them): each gets ``grace`` seconds in all to
    exit on the pool's sentinel, and any still alive then is terminated,
    so that no worker outlives the service (a leftover child would hold
    its parent's pipes open)."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10.0)


class BuildService:
    """A worker pool + digest-dedup front over ``build_schedule``.

    ``workers=None`` resolves REPRO_BUILD_WORKERS, else the CPU count;
    ``mode=None`` resolves REPRO_BUILD_MODE, else "process" when more
    than one worker is requested and "serial" otherwise.  ``device`` is
    where every build's scans run ("cuda", the default, raises without a
    card; "cpu" runs their plain torch versions); it is not part of the
    dedup key.  Usable as a context manager; ``shutdown`` is idempotent.
    """

    def __init__(self, workers: int | None = None, mode: str | None = None,
                 cache_cap: int = 1024,
                 recovery: faults.RecoveryPolicy | None = None,
                 device: str = "cuda"):
        self.workers = workers if workers is not None else default_workers()
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        mode = mode or os.environ.get(MODE_ENV) \
            or ("process" if self.workers > 1 else "serial")
        if mode not in MODES:
            raise ValueError(f"unknown build-service mode {mode!r}; "
                             f"have {MODES}")
        self.mode = mode
        self.device = kernels.check_device(device)
        self.recovery = recovery or faults.RecoveryPolicy()
        self._cache_cap = max(cache_cap, 1)
        self._lock = threading.Lock()
        self._futures: dict[tuple, Future] = {}   # dedup front + result cache
        self._pool = None
        self._closed = False
        #: the start method of the process pools ("" until one starts)
        self.start_method = ""
        #: digest_hex -> worker-crash count; quarantined digests build inline
        self._crashes: dict[str, int] = {}
        self._poison: set[str] = set()
        #: pending retry timers -> their re-dispatch args (drained on shutdown)
        self._timers: dict[threading.Timer, tuple] = {}
        #: (old submission key, delta digest) -> content key of the
        #: resulting delta build: recurring-pipeline edits dedup without
        #: re-hashing the mutated DAG
        self._rekeys: dict[tuple, tuple] = {}
        self.stats = {"submitted": 0, "built": 0, "deduped": 0,
                      "resubmits": 0, "resubmit_deduped": 0,
                      "retries": 0, "worker_crashes": 0,
                      "quarantined_digests": 0, "inline_fallbacks": 0,
                      "recovery_secs": 0.0}

    # ------------------------------------------------------------------
    def _ensure_pool(self):
        with self._lock:
            if self._pool is None and self.mode != "serial":
                if self.mode == "thread":
                    self._pool = ThreadPoolExecutor(
                        max_workers=self.workers,
                        thread_name_prefix="buildsvc")
                else:
                    self._pool = self._process_pool()
            return self._pool

    def _process_pool(self) -> ProcessPoolExecutor:
        """A process pool whose workers get the fault plan, the ``REPRO_*``
        settings and the torch thread count in force (`_init_worker`); on
        the card, the scan library is built first so that no worker runs
        nvcc."""
        import torch

        if self.device == "cuda":
            from ..kernels.placement_scan import kernel as ps_kernel

            ps_kernel.LIBRARY.build()
        ctx = _default_mp_context()
        self.start_method = ctx.get_start_method()
        plan = faults.active_plan()
        return ProcessPoolExecutor(
            max_workers=self.workers, mp_context=ctx,
            initializer=_init_worker,
            initargs=(plan.describe() if plan is not None else "",
                      torch.get_num_threads(), _repro_env()))

    def key_for(self, dag: DAG, m: int, backend=None,
                memoize: bool | None = None, **knobs) -> tuple:
        """The dedup/cache key of one submission (digest + every knob)."""
        from .builder import _memo_enabled

        items = dict(_KNOB_DEFAULTS)
        unknown = set(knobs) - set(items)
        if unknown:
            raise TypeError(f"unknown build_schedule knobs: {sorted(unknown)}")
        items.update(knobs)
        return (dag_digest(dag), int(m), get_backend(backend).name,
                bool(_memo_enabled(memoize)),
                tuple(sorted(items.items())))

    def submit(self, dag: DAG, m: int, backend=None,
               memoize: bool | None = None, **knobs) -> BuildHandle:
        """Queue one construction; returns immediately.

        Accepts the ``build_schedule`` keyword knobs (ticks, n_long,
        n_frag, max_candidates, use_partitions) plus backend/memoize.
        Equal-content submissions (same digest, same knobs) share one
        build — including ones already completed (bounded LRU cache).
        """
        key = self.key_for(dag, m, backend=backend, memoize=memoize, **knobs)
        kw = dict(knobs)
        if backend is not None:
            # resolve to the *name*: backend instances are shareable in
            # threads but must not cross a process boundary
            kw["backend"] = get_backend(backend).name
        if memoize is not None:
            kw["memoize"] = memoize
        return self._submit_keyed(key, dag, m, kw)

    def resubmit(self, handle: BuildHandle, dag: DAG,
                 delta=None) -> BuildHandle:
        """Delta resubmission: build the mutated ``dag`` with the same
        machine count and knobs as ``handle``'s submission, replaying
        every partition the edit left untouched (``build_schedule``'s
        ``reuse``; bit-identical to a fresh submit of ``dag``).

        ``delta`` is the `core.dag.DagDelta` of the edit; when given,
        (old submission key, delta digest) keys a dedup front of its own,
        so a recurring pipeline resubmitting the same edit repeatedly
        neither re-hashes the DAG nor rebuilds.  The previous build's
        parts map is only consulted if the old future already completed —
        otherwise the resubmission degrades to a full (still exact) build.
        """
        old = handle.key
        _, m, backend, memoize, knob_items = old
        knobs = dict(knob_items)
        rekey = (old, delta.digest) if delta is not None else None
        with self._lock:
            self.stats["resubmits"] += 1
            if rekey is not None:
                key = self._rekeys.get(rekey)
                fut = self._futures.get(key) if key is not None else None
                if fut is not None and not fut.cancelled() and not (
                        fut.done() and fut.exception() is not None):
                    self.stats["resubmit_deduped"] += 1
                    self.stats["submitted"] += 1
                    self.stats["deduped"] += 1
                    self._futures[key] = self._futures.pop(key)  # MRU
                    return BuildHandle(fut, dag, key)
        kw = dict(knobs)
        kw["backend"] = backend
        kw["memoize"] = memoize
        prev = handle._future
        if prev.done() and not prev.cancelled() and prev.exception() is None:
            info = prev.result()[7]
            if info is not None:
                kw["reuse"] = info.parts
        key = self.key_for(dag, m, backend=backend, memoize=memoize, **knobs)
        if rekey is not None:
            with self._lock:
                if len(self._rekeys) >= self._cache_cap:
                    self._rekeys.pop(next(iter(self._rekeys)))
                self._rekeys[rekey] = key
        return self._submit_keyed(key, dag, m, kw)

    def _submit_keyed(self, key: tuple, dag: DAG, m: int,
                      kw: dict) -> BuildHandle:
        with self._lock:
            if self._closed:
                raise RuntimeError("BuildService is shut down")
            self.stats["submitted"] += 1
            fut = self._futures.pop(key, None)
            if fut is not None and not fut.cancelled() and not (
                    fut.done() and fut.exception() is not None):
                # dedup hit — a *failed* entry is dropped instead, so a
                # deterministic build error never poisons its key: the
                # next submit retries the build
                self.stats["deduped"] += 1
                self._futures[key] = fut     # re-append = most recently used
                return BuildHandle(fut, dag, key)
            self.stats["built"] += 1
            # supervised future: pool attempts complete it indirectly, so
            # every dedup sharer survives worker crashes and retries — the
            # caller-visible future only ever fails on a build's own error
            fut = Future()
            if len(self._futures) >= self._cache_cap:
                self._futures.pop(next(iter(self._futures)))
            self._futures[key] = fut
        self._dispatch(key, fut, dag, m, kw, attempt=0)
        return BuildHandle(fut, dag, key)

    # -- supervised dispatch (retry / quarantine / inline fallback) ----

    def _dispatch(self, key: tuple, out: Future, dag: DAG, m: int,
                  kw: dict, attempt: int) -> None:
        """Route one build attempt: pool while the retry budget and the
        digest's crash record allow, guaranteed inline otherwise."""
        digest = key[0].hex()
        with self._lock:
            inline = (self.mode == "serial" or self._closed
                      or digest in self._poison
                      or attempt > self.recovery.build_retries)
            fallback = inline and self.mode != "serial"
        if inline:
            self._finish_inline(out, dag, m, kw, fallback=fallback)
            return
        pool = None
        try:
            pool = self._ensure_pool()
            wfut = pool.submit(_build_slim, dag, m, kw, self.device,
                               (digest, attempt))
        except BrokenExecutor:
            if self._note_worker_crash(digest, pool):
                pool.shutdown(wait=False)
            self._retry_later(key, out, dag, m, kw, attempt + 1)
            return
        except RuntimeError:
            # pool shut down under us — the fallback still owes a result
            self._finish_inline(out, dag, m, kw, fallback=True)
            return

        def _done(f: Future) -> None:
            if f.cancelled():               # pool torn down mid-attempt
                self._finish_inline(out, dag, m, kw, fallback=True)
                return
            exc = f.exception()
            if exc is None:
                _complete(out, result=f.result())
                return
            if isinstance(exc, BrokenExecutor):
                with self._lock:
                    closed = self._closed
                if closed:                  # workers stopped by shutdown
                    _complete(out, exc=RuntimeError(
                        "BuildService shut down during the build"))
                    return
                # worker died (os._exit, OOM kill): every in-flight
                # attempt on the pool fails with it; drop the pool (its
                # manager thread, which runs this callback, is tearing it
                # down: shutting it down from here would deadlock on the
                # pool's lock) and let each attempt retry with backoff
                self._note_worker_crash(digest, pool)
            elif not (isinstance(exc, faults.InjectedFault)
                      and exc.seam == "build_worker"):
                # the build's own error (a CUDA error, a refused launch):
                # no retry, no inline build that would hide it
                _complete(out, exc=exc)
                return
            with self._lock:
                self.stats["retries"] += 1
            self._retry_later(key, out, dag, m, kw, attempt + 1)

        wfut.add_done_callback(_done)

    def _note_worker_crash(self, digest: str, pool) -> bool:
        """Record one crash against a digest; quarantine crash-loopers;
        drop the broken ``pool`` so that the next attempt starts a new one.
        True if this call dropped it (not an earlier crash of the same
        pool).

        Attribution is conservative: a broken pool fails every in-flight
        digest, so innocents sharing the pool with a poison DAG may also
        accumulate counts — they just fall back inline (still exact).
        """
        with self._lock:
            self.stats["worker_crashes"] += 1
            n = self._crashes[digest] = self._crashes.get(digest, 0) + 1
            if (n >= max(self.recovery.quarantine_after, 1)
                    and digest not in self._poison):
                self._poison.add(digest)
                self.stats["quarantined_digests"] += 1
            dropped = pool is not None and self._pool is pool
            if dropped:
                self._pool = None
        return dropped

    def _retry_later(self, key: tuple, out: Future, dag: DAG, m: int,
                     kw: dict, attempt: int) -> None:
        rec = self.recovery
        delay = min(rec.backoff * (2.0 ** (attempt - 1)), rec.backoff_cap)
        with self._lock:
            closed = self._closed
            if not closed and delay > 0:
                self.stats["recovery_secs"] += delay
        if closed or delay <= 0:
            self._dispatch(key, out, dag, m, kw, attempt)
            return
        timer = threading.Timer(delay, self._fire_retry)
        timer.args = (timer,)
        timer.daemon = True
        with self._lock:
            if self._closed:                # raced with shutdown: no timer
                self._finish_inline(out, dag, m, kw, fallback=True)
                return
            self._timers[timer] = (key, out, dag, m, kw, attempt)
        timer.start()

    def _fire_retry(self, timer: threading.Timer) -> None:
        with self._lock:
            args = self._timers.pop(timer, None)
        if args is not None:
            self._dispatch(*args)

    def _finish_inline(self, out: Future, dag: DAG, m: int, kw: dict,
                       fallback: bool = False) -> None:
        """The guaranteed last resort: build on the calling thread.

        Never injected (no fault_key), so every submission eventually
        resolves — with the schedule, or with the build's own error.
        """
        if fallback:
            with self._lock:
                self.stats["inline_fallbacks"] += 1
        try:
            res = _build_slim(dag, m, kw, self.device)
        except Exception as exc:
            _complete(out, exc=exc)
        except BaseException as exc:  # KeyboardInterrupt/SystemExit:
            _complete(out, exc=exc)   # unblock any dedup sharer ...
            raise                     # ... but never swallow the cancel
        else:
            _complete(out, result=res)

    def build(self, dag: DAG, m: int, **kw) -> Schedule:
        return self.submit(dag, m, **kw).result()

    def build_many(self, dags: Sequence[DAG], m: int, **kw) -> list[Schedule]:
        """All DAGs through the pool; results in input order.

        Bit-identical to ``[build_schedule(d, m, **kw) for d in dags]``,
        just overlapped and deduplicated.
        """
        handles = [self.submit(d, m, **kw) for d in dags]
        return [h.result() for h in handles]

    # ------------------------------------------------------------------
    def clear_cache(self) -> None:
        with self._lock:
            self._futures.clear()

    def shutdown(self, wait: bool = True) -> None:
        """Stop the service.  ``wait=False`` cancels queued attempts and
        terminates the pool's live worker processes instead of waiting for
        them."""
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, None
            timers = list(self._timers.items())
            self._timers.clear()
        # drain pending retries so no supervised future is left dangling:
        # finish inline when waiting, cancel outright otherwise
        for timer, (key, out, dag, m, kw, attempt) in timers:
            timer.cancel()
            if out.done():
                continue
            if wait:
                self._finish_inline(out, dag, m, kw, fallback=True)
            elif not out.cancel():
                _complete(out, exc=RuntimeError(
                    "BuildService shut down before retry"))
        if pool is not None:
            procs = list((getattr(pool, "_processes", None) or {}).values())
            try:
                pool.shutdown(wait=wait, cancel_futures=not wait)
            finally:
                _stop_workers(procs)

    def __enter__(self) -> "BuildService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=exc[0] is None)


def build_many(dags: Sequence[DAG], m: int, workers: int | None = None,
               mode: str | None = None, device: str = "cuda",
               **kw) -> list[Schedule]:
    """One-shot convenience: a scoped service around ``build_many``."""
    with BuildService(workers=workers, mode=mode, device=device) as svc:
        return svc.build_many(dags, m, **kw)
