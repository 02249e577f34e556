"""The data-parallel trainer's entry: `Trainer(mesh)` over `ranks` process
ranks, one per card, each step a batch of `batch` views (batch / ranks a
rank), as `train --devices <ranks> --batch <batch>` runs it.

Rank 0 is this process, the harness's `Session` on `cuda:0`; it starts
ranks 1.. as processes of `train_ranks_peer.py` on `cuda:1..` (gloo ranks
on the CPU where the harness runs on the CPU).  Every rank draws the
scene and the model from the seed, renders the trained views' targets,
joins the process group (`parallel.init_distributed`, a `tcp://`
rendezvous), replicates the model from rank 0 (`replicate_model`), plans
capacity over the first `plan_views` views and builds
`Trainer(mesh=...)`, as the CLI does.  A step makes the batch's camera
rays (`parallel.camera_batch`: the CLI's cadence) and stacks its targets
on every rank; each rank renders its share, and the trainer averages the
gradients and the loss over the ranks (`average_gradients`) before Adam.

The batches: `check_steps` at set-up, from the mix's check stream (each
batch the next `batch` views of one seeded permutation), then in the
window consecutive draws of `Mix.steps()`, a draw that repeats a view
already in its batch skipped, so that a batch holds distinct views.
Every rank draws the same batches from the seed.  Rank 0 releases each
window step to its peers through a store of its own (the host-side key
`go{i}`, never a device collective); `release()` posts the stop, checks
the replicas again, joins the peers under a deadline (killing them past
it) and destroys the group.

Compared after the window, on rank 0's card: `loss_gap`, `grad_gap`,
`change_gap`, `target_off` and `hits_per_ray` as `entries/train.py`
defines them, against the reference's batch steps (`reference/batch.py`)
from the same scene, seed and views; and `replica_gap`, the largest
difference of any parameter between rank 0 and a peer after the checked
steps and after the window (rank 0's leaves broadcast, each peer's gap
sent back through the store).

A watchdog thread on rank 0 ends every rank (exit status 5) when a peer
exits with an error, or when the set-up, a window step or the release
outruns its deadline; a peer ends itself (the same status) when rank 0
has gone.  So a run that cannot go on fails within minutes; it never
waits on a dead rank.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from portbench import harness as h
from portbench.generator import Mix
from portbench.reference import adam as ref_adam
from portbench.reference import batch as ref_batch
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import composite as ref_comp
from portbench.reference.math import activate, param_rows
from portbench.scene import draw

SYNC_EACH_UNIT = False

#: the watchdog's deadlines (s): the set-up (kernel builds, targets, the
#: group, the checked steps), one window step, the release
SETUP_S, STEP_S, RELEASE_S = 480.0, 120.0, 180.0
#: the exit status of a run that the watchdog ends
EXIT_WATCHDOG = 5
PEER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "train_ranks_peer.py")

_train = h.load_entry("train")   # the compared numbers, as train.py's


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def open_store(port: int, world: int, master: bool):
    """The control store of the run, held by rank 0."""
    return dist.TCPStore("localhost", port, world, master,
                         timeout=datetime.timedelta(seconds=SETUP_S),
                         wait_for_workers=False)


def window_batches(mix: Mix, batch: int):
    """The window's batches, without end: consecutive draws of the mix's
    steps, a draw that repeats a view of its batch skipped."""
    steps = mix.steps()
    while True:
        views = []
        while len(views) < batch:
            j = next(steps)
            if j not in views:
                views.append(j)
        yield views


def check_batches(traffic: dict, config: dict, seed: int, batch: int):
    """The `check_steps` batches of set-up: the next `batch` views of the
    mix's check stream each, a view held one step."""
    n = int(traffic["check_steps"])
    order = Mix({**traffic, "check_steps": n * batch, "check_hold": 1},
                config, seed).check_order()
    return [order[k * batch:(k + 1) * batch] for k in range(n)]


class Rank:
    """One rank's data, model and trainer: what rank 0's session and each
    peer hold alike."""

    def __init__(self, gt, config: dict, traffic: dict, seed: int,
                 rank: int, devices: list, init_method: str):
        c, t = config, traffic
        if t.get("rays", "each_step") != "each_step":
            raise ValueError("train_ranks makes each step's rays: the mix's "
                             "rays must be \"each_step\"")
        self.world, self.rank = int(c["ranks"]), rank
        self.batch = int(c["batch"])
        if self.batch % self.world:
            raise ValueError(f"a batch of {self.batch} views does not split "
                             f"over {self.world} ranks")
        per = self.batch // self.world
        self.share = slice(rank * per, (rank + 1) * per)
        self.dev = dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.gt, self.cfg = gt, h.render_config(gt, c)
        width, height = h.size(c)
        scene, perturbed = draw(c, seed, dev, t["perturb"])
        mix = Mix(t, c, seed)
        self.pool = mix.pool()
        self.cams = [h.camera(gt, v) for v in self.pool]
        plan_cams = self.cams[:int(t["plan_views"])]
        # the targets, before the group: a mesh of this process alone
        scene_model = gt.GaussianModel(*scene)
        planner = gt.render.TiledRenderer(width, height, self.cfg, device=dev)
        cap = planner.plan(scene_model, plan_cams)
        alone = gt.parallel.make_mesh(1, devices=[dev])
        self.targets = {}
        with torch.no_grad():
            for j in mix.trained():
                one = gt.parallel.camera_batch([self.cams[j]], self.cfg, dev)
                self.targets[j] = gt.parallel.render_batch_sharded(
                    scene_model, one, alone, width, height, self.cfg,
                    *cap)[0, ..., 0:3].contiguous()
                del one
        del scene_model, scene, planner
        h.log(f"train_ranks: rank {rank}: targets rendered")
        gt.parallel.init_distributed(init_method, self.world, rank,
                                     device=dev)
        self.mesh = gt.parallel.make_mesh(self.world, devices=devices)
        self.model = gt.parallel.replicate_model(gt.GaussianModel(*perturbed),
                                                 self.mesh)
        del perturbed
        planner = gt.render.TiledRenderer(width, height, self.cfg, device=dev)
        capacity = planner.plan(self.model, plan_cams)
        del planner
        tc = gt.train.TrainConfig(**t.get("train_config", {}))
        self.trainer = gt.train.Trainer(width, height, self.cfg, tc, capacity,
                                        mesh=self.mesh)
        self.state = self.trainer.init(self.model)
        self.check = check_batches(t, c, seed, self.batch)
        self.batches = window_batches(mix, self.batch)
        h.log(f"train_ranks: rank {rank}: trainer built")

    def step(self, views) -> torch.Tensor:
        """One batch step on the views (pool indices); the averaged loss."""
        gt = self.gt
        cams = gt.parallel.camera_batch([self.cams[j] for j in views],
                                        self.cfg, self.dev)
        tgt = torch.stack([self.targets[j] for j in views])
        self.state, loss = self.trainer.step(self.state, cams, tgt)
        return loss

    def replica_gap(self, store, tag: str) -> float:
        """Rank 0's leaves broadcast; each peer's largest |difference| (a
        NaN reads inf) sent through the store.  Rank 0 returns the largest
        over the peers, a peer its own."""
        worst = 0.0
        with torch.no_grad():
            for p in self.model.leaves():
                buf = p.detach().clone()
                dist.broadcast(buf, 0, group=self.mesh.group)
                d = torch.nan_to_num((p.detach() - buf).abs(),
                                     nan=float("inf"))
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
                del buf, d
        if self.rank:
            store.set(f"gap.{tag}.{self.rank}", repr(worst))
            return worst
        return max([worst] + [float(store.get(f"gap.{tag}.{r}"))
                              for r in range(1, self.world)])

    def close(self):
        self.trainer = self.model = self.state = self.targets = None
        if dist.is_initialized():
            dist.destroy_process_group()


class Watchdog:
    """Ends every rank, and this process, when a peer exits with an error
    or the armed deadline passes."""

    def __init__(self, procs):
        self.procs, self.deadline, self.what = procs, None, ""
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def arm(self, seconds: float, what: str):
        self.what = f"{what} ({seconds:.0f} s)"
        self.deadline = time.monotonic() + seconds

    def stop(self):
        self.stopped.set()
        self.thread.join()

    @contextlib.contextmanager
    def guard(self, what: str):
        """End every rank when the block raises: an error must not leave
        the peers waiting in a collective, nor this process in its exit."""
        try:
            yield
        except BaseException:
            traceback.print_exc()
            self._end(f"{what} raised")

    def _run(self):
        while not self.stopped.wait(0.5):
            failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                      if p.poll() not in (None, 0)]
            if failed:
                self._end(f"rank(s) exited with {failed}")
            if self.deadline is not None and time.monotonic() > self.deadline:
                self._end(f"the deadline of {self.what} passed")

    def _end(self, why: str):
        h.log(f"train_ranks: watchdog: {why}; ending every rank")
        for p in self.procs:
            p.kill()
        os._exit(EXIT_WATCHDOG)


def exit_with_parent():
    """End this process (status EXIT_WATCHDOG) once its parent has gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(EXIT_WATCHDOG)
    threading.Thread(target=watch, daemon=True).start()


def peer(gt, spec: dict) -> int:
    """A peer rank's whole run (`train_ranks_peer.py`); an error ends the
    process at once (status 1), so that rank 0 sees it."""
    exit_with_parent()
    try:
        return _peer(gt, spec)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _peer(gt, spec: dict) -> int:
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    store = open_store(spec["store_port"], spec["world"], False)
    rank = Rank(gt, spec["config"], spec["traffic"], spec["seed"],
                spec["rank"], spec["devices"], spec["init_method"])
    for views in rank.check:
        rank.step(views)
    rank.replica_gap(store, "check")
    i = 0
    while store.get(f"go{i}") == b"step":
        rank.step(next(rank.batches))
        i += 1
    rank.replica_gap(store, "end")
    rank.close()
    return 0


class Session:
    def __init__(self, ctx: h.Context):
        self.ctx = ctx
        gt, cell, seed, dev = ctx.gt, ctx.cell, ctx.seed, ctx.dev
        c, t = cell.config, cell.traffic
        world = int(c["ranks"])
        devices = [f"cuda:{r}" if dev.type == "cuda" else "cpu"
                   for r in range(world)]
        port, init = _free_port(), f"tcp://localhost:{_free_port()}"
        self.store = open_store(port, world, True)
        self.procs = []
        for r in range(1, world):
            spec = {"config": c, "traffic": t, "seed": seed, "rank": r,
                    "world": world, "devices": devices, "init_method": init,
                    "store_port": port,
                    "threads": (torch.get_num_threads()
                                if dev.type == "cpu" else None)}
            self.procs.append(subprocess.Popen(
                [sys.executable, PEER, json.dumps(spec)], cwd=h.ROOT,
                stdin=subprocess.DEVNULL, stdout=2))
        self.watch = Watchdog(self.procs)
        self.watch.arm(SETUP_S, "the set-up")
        with self.watch.guard("the set-up"):
            self._set_up(gt, c, t, seed, dev, devices, init)

    def _set_up(self, gt, c, t, seed, dev, devices, init):
        self.rank = rank = Rank(gt, c, t, seed, 0, devices, init)
        self.pool, self.check = rank.pool, rank.check
        model = rank.model
        p0 = [p.detach().to("cpu", copy=True) for p in model.leaves()]
        prog = {"loss": []}
        for k, views in enumerate(self.check):
            prog["loss"].append(float(rank.step(views)))
            if k == 0:   # the averaged gradient the optimizer took
                prog["grad"] = _train._leaf_norms(
                    [p.grad for p in model.leaves()])
        prog["change"] = [float(torch.linalg.vector_norm(
            p.detach() - q.to(dev))) for p, q in zip(model.leaves(), p0)]
        del p0
        self.replica = rank.replica_gap(self.store, "check")
        h.sync(dev)
        h.log(f"train_ranks: first steps {prog['loss']} on {self.check}, "
              f"replica gap {self.replica}")
        self.prog = prog
        self.kept_targets = {
            j: ref_cam.to_tiles(rank.targets[j], self.rank.cfg.tile_size)
            .to("cpu", copy=True) for views in self.check for j in views}
        self.start_leaves = None
        self.units = 0
        self.unit_views = []

    def start(self):
        if self.ctx.trace:
            self.start_leaves = [p.detach().to("cpu", copy=True)
                                 for p in self.rank.model.leaves()]

    def unit(self, i: int) -> int:
        views = next(self.rank.batches)
        self.store.set(f"go{i}", "step")
        self.watch.arm(STEP_S, f"window step {i}")
        with self.watch.guard(f"window step {i}"):
            self.rank.step(views)
        self.units = i + 1
        self.unit_views = [self.pool[j] for j in views[self.rank.share]]
        return 0

    def release(self):
        self.watch.arm(RELEASE_S, "the release")
        self.store.set(f"go{self.units}", "stop")
        with self.watch.guard("the release"):
            self.replica = max(self.replica,
                               self.rank.replica_gap(self.store, "end"))
            self.rank.close()
        self.rank = None
        end = time.monotonic() + RELEASE_S / 2
        for p in self.procs:
            try:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                h.log(f"train_ranks: a peer outlived the release: killed")
                p.kill()
                p.wait()
        self.watch.stop()
        codes = [p.returncode for p in self.procs]
        h.log(f"train_ranks: peers exited {codes}, replica gap "
              f"{self.replica}")
        if any(codes):
            self.replica = float("inf")

    def _ref_targets(self, dtype):
        """The reference's render of the scene at each checked view: (tiles,
        3, R) rgb per pool index, composited in `dtype`."""
        c, dev = self.ctx.cell.config, self.ctx.dev
        st = h.settings(c)
        scene, _ = draw(c, self.ctx.seed, dev)
        act = activate(*scene)
        rows = param_rows(act).to(dtype)
        out = {}
        for j in sorted({j for views in self.check for j in views}):
            view = self.pool[j]
            w2c, proj = ref_cam.matrices(view, st)
            binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                       view.height, st)
            rays = ref_cam.tile_rays(view, st, dev)
            out[j] = ref_comp.render(rows, binned, rays, st)[:, 0:3].float()
            del binned, rays
        return out

    def reference_steps(self, dtype=torch.float32):
        """The reference's checked batch steps from the same inputs: the
        losses, the first gradient's and the change's norms per leaf, the
        first batch's mean hits per ray, and its targets."""
        cell, dev = self.ctx.cell, self.ctx.dev
        st = h.settings(cell.config)
        targets = self._ref_targets(dtype)
        _, leaves = draw(cell.config, self.ctx.seed, dev,
                         cell.traffic["perturb"])
        params = [x.clone() for x in leaves]
        opt = ref_adam.Adam(params)
        out = {"loss": [], "targets": targets}
        for k, views in enumerate(self.check):
            loss, grads, hits = ref_batch.batch_step(
                params, opt, [self.pool[j] for j in views],
                [targets[j] for j in views], st, dtype)
            out["loss"].append(loss)
            if k == 0:
                out["grad"] = _train._leaf_norms(grads)
                out["hits_per_ray"] = hits
            del grads
        out["change"] = _train._leaf_norms(
            [p - q for p, q in zip(params, leaves)])
        return out

    def readings(self, control: bool):
        ref = self.reference_steps()
        want = ref["targets"]
        self.prog["target_off"] = max(
            _train.target_off(self.kept_targets[j], want[j]) for j in want)
        prog = _train.numbers(self.prog, ref)
        prog["replica_gap"] = self.replica
        out = {"prog": prog}
        if control:
            low = self.reference_steps(torch.bfloat16)
            low["target_off"] = max(
                _train.target_off(low["targets"][j], want[j]) for j in want)
            out["ctrl"] = {**_train.numbers(low, ref), "replica_gap": 0.0}
        return out

    def bound_leaves(self):
        return [x.to(self.ctx.dev) for x in self.start_leaves]
