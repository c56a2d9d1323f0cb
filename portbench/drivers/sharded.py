"""One frame split over the cards of one host: `RayTracer.render_sharded(spp)`
on `ranks` processes, one card each, joined over NCCL (gloo on the CPU),
back to back, each render into a fresh film (a closed loop of one
client).  Each rank traces its row-major slice of the frame with its own
draws, and the film's moments are all-gathered, so rank 0 holds the
whole frame once the slowest rank is done.  The end-to-end metric,
`sharded_mrays_s`, is the primary rays of every render completed in the
window over the window's time, on rank 0's clock (the render loop's
`primary_mrays_s`, under a bound of its own).

Rank 0 is the harness's own process, on card 0.  Set-up loads the port's
kernels (so the build cache is warm), starts ranks 1..n-1 as this file
run as a script, on cards 1..n-1,

    python3 portbench/drivers/sharded.py '<the worker's arguments as JSON>'

joins the n ranks through `parallel.mesh.initialize_distributed` on a
free local port, builds the same RayTracer on every rank as the render
loop builds it, and runs one warm-up render on all.  On the cards each
rank keeps to its own block of the host's cores, with as many torch
threads.  Before each render rank 0 writes GO to every worker's standard
input and every rank renders; `release()` writes STOP and joins the
workers.  The signal goes by pipe and not by a collective: a worker
waits in it while rank 0 reads a traced window, longer than NCCL lets a
collective wait.  A worker exits nonzero when it has loaded JAX or the
JAX package, or when its parent is gone.  Rank 0 kills the workers on
any exception and at exit; a worker that dies while the ranks render
ends the run with no result within `GRACE_S` (NCCL tells the other ranks
nothing, so they would wait for it).

The check: renders drawn from the seed (and the last one), each at
pixels drawn from the seed, as the render loop draws them; the reference
traces every sample of those pixels with the draws of the rank that
traced it (`draws.split_sample_seeds`, `layout.row_major_slice`) and
takes the film's mean.  The number compared is sum |program - reference|
/ sum |reference| over them.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__":      # a worker: portbench from the checkout
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench.draws import split_sample_seeds  # noqa: E402
from portbench.drivers import render  # noqa: E402
from portbench.faults import _patched  # noqa: E402
from portbench.layout import row_major_slice  # noqa: E402
from portbench.reference import render as ref  # noqa: E402

GO, STOP = b"g", b"s"
JOIN_S = 60.0       # a worker's time to end after STOP, or after a kill
GRACE_S = 20.0      # rank 0's time to fail by itself once a worker died
POLL_S = 0.2
LOG_TAIL = 2000     # characters of a failed worker's output shown

# faults every rank plants (tests and readings only): the loop's own
# three, and the exchange between the cards left out
FAULTS = ("unchanged", "half", "altered", "no_exchange")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _blocks(ranks):
    """Each rank's block of the cores this process may use: the r-th of
    `ranks` equal runs of the sorted core numbers."""
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // ranks)
    return [cores[r * k:(r + 1) * k] or cores for r in range(ranks)]


def _pin(cores):
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))


class Session(render.Session):
    planted = None          # the fault the workers plant too (`plant`)

    def setup(self):
        mix = self.mix
        self.ranks, self.spp = mix["ranks"], mix["spp"]
        self.workers, self._logs = [], []
        self._closed = False
        cuda = self.device.type == "cuda"
        self._cores = sorted(os.sched_getaffinity(0))
        self._threads = torch.get_num_threads()
        atexit.register(self._end)
        try:
            blocks = [None] * self.ranks
            if cuda:
                self.port.ops.cuda_bvh._load()
                blocks = _blocks(self.ranks)
                print(f"portbench: cores of each rank {blocks}",
                      file=sys.stderr)
            self.addr = f"tcp://127.0.0.1:{_free_port()}"
            for rank in range(1, self.ranks):
                self._start(rank, blocks[rank])
            if cuda:
                _pin(blocks[0])
            threading.Thread(target=self._watch, daemon=True).start()
            self.rt = self._join(0)
            self.done = 0
            self.picks = set(int(i) for i in self.rng(0).integers(
                0, render.PICK_WITHIN, size=mix["check"]["renders"] - 1))
            self.kept_renders = {}
            self.last = None
            self._render()                  # warm-up: every shape, every rank
            self.sync()
        except BaseException:
            self._end()
            raise

    # -- the ranks ---------------------------------------------------------

    def _start(self, rank, cores):
        args = {"addr": self.addr, "rank": rank, "seed": self.seed,
                "cfg": self.cfg, "mix": self.mix, "parent": os.getpid(),
                "device": "cpu" if self.device.type != "cuda"
                else f"cuda:{rank}",
                "cores": cores, "threads": torch.get_num_threads(),
                "fault": self.planted}
        log = tempfile.TemporaryFile()
        self._logs.append(log)
        self.workers.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(args)],
            stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.PIPE))

    def _join(self, rank):
        """This process joins the group as `rank`; its RayTracer."""
        self.port.parallel.mesh.initialize_distributed(
            init_method=self.addr, world_size=self.ranks, rank=rank,
            device=self.device)
        scene = self.port.models.collada.ColladaLoader.from_file(
            self.path, width=self.width, height=self.height, verbose=False)
        cfg = self.cfg
        rt = self.port.RayTracer(
            scene, self.width, self.height,
            triangles_per_leaf=cfg["triangles_per_leaf"], accel=cfg["accel"],
            recursions=cfg["recursions"], spread=cfg["spread"],
            spp_pool=self.mix["pool"], device=self.device, draws=self.draws)
        self.check_fused(rt)
        return rt

    def _signal(self, flag):
        """Rank 0: `flag` to every worker."""
        for k, p in enumerate(self.workers):
            try:
                p.stdin.write(flag)
                p.stdin.flush()
            except BrokenPipeError:
                raise RuntimeError(f"rank {k + 1} is gone") from None

    def serve(self, rank, signals):
        """A worker's loop: render on each GO that rank 0 writes to
        `signals`, until STOP; the last signal read."""
        self.ranks, self.spp = self.mix["ranks"], self.mix["spp"]
        rt = self._join(rank)
        try:
            while (flag := signals.read(1)) == GO:
                rt.film.clear()
                rt.render_sharded(self.spp)
        finally:
            del rt
            dist.destroy_process_group()
        return flag

    def _log(self, k):
        log = self._logs[k]
        log.seek(0)
        return log.read().decode(errors="replace")

    def _watch(self):
        """Rank 0: a worker that ends while the ranks still render ends
        the run, unless rank 0 fails by itself first (gloo tells it)."""
        while not self._closed:
            dead = [k for k, p in enumerate(self.workers)
                    if p.poll() is not None]
            if dead and not self._closed:
                k = dead[0]
                print(f"portbench: rank {k + 1} ended with code "
                      f"{self.workers[k].returncode} while the ranks "
                      f"rendered:\n{self._log(k)[-LOG_TAIL:]}",
                      file=sys.stderr, flush=True)
                for p in self.workers:
                    if p.poll() is None:
                        p.kill()
                until = time.monotonic() + GRACE_S
                while not self._closed and time.monotonic() < until:
                    time.sleep(POLL_S)
                if not self._closed:
                    os._exit(5)
                return
            time.sleep(POLL_S)

    def _end(self):
        """Kill every worker still running and leave the group: on any
        exception on rank 0, and at exit."""
        self._closed = True
        for p in self.workers:
            if p.poll() is None:
                p.kill()
        for p in self.workers:
            p.wait(timeout=JOIN_S)
        self._leave()

    def _leave(self):
        """Leave the group, and give this process back its cores."""
        if dist.is_initialized():
            dist.destroy_process_group()
        os.sched_setaffinity(0, self._cores)
        torch.set_num_threads(self._threads)
        atexit.unregister(self._end)

    # -- the loop ------------------------------------------------------------

    def end_to_end(self, window_s, latencies):
        rate = super().end_to_end(window_s, latencies)["primary_mrays_s"]
        return {"sharded_mrays_s": rate}

    def _render(self):
        try:
            self._signal(GO)
            self.rt.film.clear()
            return self.rt.render_sharded(self.spp)
        except BaseException:
            self._end()
            raise

    def release(self):
        del self.rt
        self._closed = True
        for p in self.workers:
            with contextlib.suppress(BrokenPipeError):
                p.stdin.write(STOP)
                p.stdin.close()
        self.sync()
        dist.destroy_process_group()        # with the workers, not after
        for p in self.workers:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=JOIN_S)
        self._leave()
        failed = []
        for k, p in enumerate(self.workers):
            out = self._log(k)
            peak = [line for line in out.splitlines()
                    if line.startswith("peak ")]
            if peak:
                print(f"portbench: rank {k + 1} {peak[-1]} bytes",
                      file=sys.stderr)
            if p.returncode != 0:
                failed.append(f"rank {k + 1} ended with code "
                              f"{p.returncode}:\n{out[-LOG_TAIL:]}")
        if failed:
            raise RuntimeError("\n".join(failed))

    # -- the check -----------------------------------------------------------

    def reference(self, dtype):
        scene, camera = self.load_scene(dtype)
        W, H, spp = self.width, self.height, self.spp
        last = max(self.kept_renders)
        # render g of the run: the warm-up is 0, the window's i is i + 1
        seeds = split_sample_seeds(self.seed, last + 2, self.ranks, spp)
        out = {}
        for i in sorted(self.kept_renders):
            px, py = self._pixels(i)
            rank, idx, share = row_major_slice(px, py, W, H, self.ranks)
            mean = np.zeros((px.size, 3), np.float32)
            for r in np.unique(rank):
                sel = np.nonzero(rank == r)[0]
                total = None
                for s in seeds[i + 1][r]:       # sample by sample, as the film
                    o, d, g0, g1 = self.sample_rays(s, share, idx[sel], camera,
                                                    px[sel], py[sel], dtype)
                    with torch.no_grad():
                        rad = ref.radiance(scene, o, d, g0, g1,
                                           scene["tri_verts"]).float()
                    total = rad if total is None else total + rad
                mean[sel] = (total * (1.0 / spp)).cpu().numpy()
            out[i] = mean
        return out


def _alone(mesh, local):
    """This rank's shard in its place and zeros in every other rank's:
    the exchange between the cards left out."""
    n = local.shape[0]
    out = local.new_zeros((mesh.size * n,) + tuple(local.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = local
    return out


@contextlib.contextmanager
def plant(port, fault):
    """A context manager in which the program has `fault` on every rank
    (the workers started inside it plant it too): a render that adds
    nothing to the film; half the samples; every radiance 5 % brighter;
    the all-gather left out."""
    engine = port.core.engine
    rt = engine.RayTracer
    if fault == "unchanged":
        patch = _patched(rt, "render_sharded",
                         lambda self, spp=1, mesh=None: self.get_hdr())
    elif fault == "half":
        sharded = rt.render_sharded
        patch = _patched(rt, "render_sharded",
                         lambda self, spp=1, mesh=None:
                         sharded(self, spp // 2, mesh))
    elif fault == "altered":
        loops = port.parallel.render
        fused = loops.trace_radiance_fused
        patch = _patched(loops, "trace_radiance_fused",
                         lambda *a, **k: fused(*a, **k) * 1.05)
    elif fault == "no_exchange":
        patch = _patched(engine, "all_gather_rays", _alone)
    else:
        raise ValueError(f"no fault {fault!r} for the sharded loop")
    with patch, _patched(Session, "planted", fault):
        yield


def _exit_when_orphaned(parent):
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(3)


def worker(args):
    """Rank `args["rank"]` of the group: returns its exit code."""
    threading.Thread(target=_exit_when_orphaned, args=(args["parent"],),
                     daemon=True).start()
    from portbench import run
    run.environment()
    if args["cores"]:
        _pin(args["cores"])
    else:
        torch.set_num_threads(args["threads"])
    port = run.import_port()
    session = Session(port, args["cfg"], args["mix"], args["seed"],
                      args["device"], ROOT)
    session.addr = args["addr"]
    with (plant(port, args["fault"]) if args["fault"]
          else contextlib.nullcontext()):
        flag = session.serve(args["rank"], sys.stdin.buffer)
    if session.device.type == "cuda":
        print(f"peak {torch.cuda.max_memory_allocated(session.device)}",
              flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"portbench: rank {args['rank']} loaded {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 4
    if flag != STOP:
        print(f"portbench: rank {args['rank']}: rank 0 is gone",
              file=sys.stderr, flush=True)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))
