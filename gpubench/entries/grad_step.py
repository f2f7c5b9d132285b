"""A frame is one gradient step of an inverse-rendering loop, as
examples/torch/invert_cbox.py runs it: `render_l2_grad` against a target
image, `adam_step` on the scene's differentiable tables, `with_tables`.

Set-up renders the target from the unperturbed scene, sets the traffic's
parameter to its start value, and drives the optimiser through its first
CHECK_STEPS steps with the window's own call; the window goes on with the
same object. The plain reference follows those first steps from the
same inputs and seeds, with an Adam of its own, and the check compares
each step's loss, the first step's image, the first gradient as the
optimiser received it (worked out from Adam's first moment after one
step), and the tables' change after the last of them.

It also judges one step of the window, drawn from the run's seed: the
reference takes the program's parameter values before that step (it
cannot follow the window's steps on its own in the check's time) and
recomputes the step's loss, image and gradient, the last as Adam
received it (from its first moment before and after the step), and the
step's change of the tables, by its own Adam from the program's moments
before the step; these join the worst loss, image, gradient and change
gaps above."""
from __future__ import annotations

import math

import torch

from gpubench.reference import pathtracer

from . import common

CHECK_STEPS = 3
# the program's differentiable tables and the reference's, pairwise:
# a material's reflectance and an area emitter's radiance
LEAVES = {"mat_data": "reflectance", "emitter_data": "radiance"}


class Entry:
    metric = "grad_mrays_per_s"

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.cfg = common.render_config(run.api, self.t)
        self.adam = self.t["adam"]

    def _step(self, k: int):
        api, run = self.run.api, self.run
        rec = torch.profiler.record_function
        with rec("gpubench.render_l2_grad"):
            img, loss, grads = api.render_l2_grad(
                self.scene, self.cfg, self.target,
                seed=run.seed_of("step", k), device=run.device)
        with rec("gpubench.adam_step"):
            self.theta, self.state = api.adam_step(
                self.theta, grads, self.state, lr=self.adam["lr"],
                beta_1=self.adam["beta_1"], beta_2=self.adam["beta_2"],
                epsilon=self.adam["epsilon"])
        with rec("gpubench.with_tables"):
            self.scene = api.with_tables(self.scene, self.theta)
        return img, loss

    def _grad_received(self, before, after) -> dict:
        """The gradient Adam received in a step, from its first moment
        before and after it: m' = beta_1 m + (1 - beta_1) g."""
        b1 = self.adam["beta_1"]
        return {n: (after["m"][n] - b1 * before["m"][n]).detach() / (1 - b1)
                for n in after["m"]}

    def setup(self):
        api, run, t = self.run.api, self.run, self.t
        self.target = api.render(run.scene, self.cfg,
                                 seed=run.seed_of("target", 0),
                                 device=run.device)
        start = torch.full((3,), float(t["init"]))
        self.scene = api.scene_with(run.scene, {t["param"]: start})
        self.theta = api.diff_tables(self.scene)
        self.state = api.adam_init(self.theta)
        self.theta0 = {k: v.detach().clone() for k, v in self.theta.items()}
        self.losses = []
        for k in range(CHECK_STEPS):
            img, loss = self._step(k)
            self.losses.append(float(loss))
            if k == 0:
                self.image0 = img.detach().clone()
                # Adam's first moment after one step is (1 - beta_1) g
                self.grad0 = {n: m.detach() / (1.0 - self.adam["beta_1"])
                              for n, m in self.state["m"].items()}
        self.change = {k: (self.theta[k] - self.theta0[k]).detach().clone()
                       for k in self.theta0}
        self.window = []
        run.sync()

    def frame(self, k: int):
        # the step's inputs and outputs, held (not copied) for the check:
        # adam_step and render_l2_grad return new tensors
        theta, before = self.theta, self.state
        img, loss = self._step(CHECK_STEPS + k)
        self.window.append((CHECK_STEPS + k, theta, before, self.theta,
                            self.state, img, loss))

    def trace_extras(self) -> dict:
        """adjoint_over_forward: the mean time of two steps over that of
        two forward renders of the same scene and config, in turns."""
        run = self.run
        step_s, fwd_s = [], []
        for k in range(2):
            t0 = run.clock()
            with torch.profiler.record_function("gpubench.render"):
                run.api.render(self.scene, self.cfg,
                               seed=run.seed_of("forward", k),
                               device=run.device)
            run.sync()
            t1 = run.clock()
            self._step(10_000 + k)
            run.sync()
            fwd_s.append(t1 - t0)
            step_s.append(run.clock() - t1)
        return {"adjoint_over_forward": sum(step_s) / sum(fwd_s)}

    def release(self):
        """Keep the drawn window step's readings (the parameter values
        and Adam's moments before it by name, as the reference needs
        them; its gradient, change, image and loss), then drop the
        program's state."""
        api, run = self.run.api, self.run
        gen = torch.Generator().manual_seed(run.seed_of("check", 0))
        i = int(torch.randint(len(self.window), (1,), generator=gen))
        step, theta, before, theta_after, after, img, loss = self.window[i]

        def by_name(tables):
            p = api.traverse(api.with_tables(self.scene, tables))
            return {n: p[n].detach().cpu() for n in p.keys()}
        self.win = {"step": step, "image": img, "loss": float(loss),
                    "grad": self._grad_received(before, after),
                    "change": {k: (theta_after[k] - theta[k]).detach()
                               for k in theta},
                    "values": by_name(theta), "m": by_name(before["m"]),
                    "v": by_name(before["v"]), "t": int(before["step"])}
        self.window = None
        self.scene = self.theta = self.state = self.run.scene = None

    def check(self, dtype=torch.float32):
        """[(name, value, limit)]: each step's loss, the image, the
        gradient and the tables' change, each the worse of set-up's (the
        first step's; the change after three) and the window step's, the
        last two by the worst leaf: the gap between the program's norm
        and the reference's, over the larger of the reference's leaf norm
        and its median leaf's."""
        run, t = self.run, self.t
        ref = pathtracer.build(run.spec, run.device, dtype)
        target = pathtracer.render(ref, t, run.seed_of("target", 0))
        shape_id = t["param"].split(".")[0]
        ref = pathtracer.with_reflectance(ref, shape_id, [t["init"]] * 3)
        params = {"reflectance": ref.reflectance, "radiance": ref.radiance}
        start = {k: v.clone() for k, v in params.items()}
        adam = RefAdam(params, **self.adam)
        losses = []
        for k in range(CHECK_STEPS):
            img, loss, grads = pathtracer.l2_grad(
                ref, t, run.seed_of("step", k), target)
            losses.append(float(loss))
            if k == 0:
                image0, grad0 = img, grads
            params = adam.step(grads)
            ref.reflectance, ref.radiance = (params["reflectance"],
                                             params["radiance"])
        change = {k: params[k] - start[k] for k in params}
        # the drawn window step, from the program's values before it
        w = self.win
        ref_w = pathtracer.with_values(ref, w["values"])
        img_w, loss_w, grads_w = pathtracer.l2_grad(
            ref_w, t, run.seed_of("step", w["step"]), target)
        # its Adam update, from the program's moments before it
        adam_w = RefAdam({"reflectance": ref_w.reflectance,
                          "radiance": ref_w.radiance}, **self.adam)
        adam_w.resume(pathtracer.with_values(ref, w["m"]),
                      pathtracer.with_values(ref, w["v"]), w["t"])
        after_w = adam_w.step(grads_w)
        change_w = {"reflectance": after_w["reflectance"] - ref_w.reflectance,
                    "radiance": after_w["radiance"] - ref_w.radiance}
        prog_loss = self.losses + [w["loss"]]
        ref_loss = losses + [float(loss_w)]
        # per-step and per-entry readings, for calibrate.py
        self.diag = {"loss_prog": prog_loss, "loss_ref": ref_loss,
                     "window_step": w["step"],
                     "grad_prog": {k: v[:, :3].flatten().tolist()
                                   for k, v in self.grad0.items()},
                     "grad_ref": {k: v.flatten().tolist()
                                  for k, v in grad0.items()}}
        # the window step's own gaps, for calibrate.py
        self.diag["window"] = {
            "loss_gap": abs(w["loss"] - float(loss_w)) / max(
                abs(float(loss_w)), 1e-30),
            "image_rel_l1": rel_l1(w["image"], img_w),
            "grad_gap": leaf_gap(w["grad"], grads_w),
            "change_gap": leaf_gap(w["change"], change_w)}
        lim = t["limits"]
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(prog_loss, ref_loss))
        image = max(rel_l1(self.image0, image0), rel_l1(w["image"], img_w))
        grad = max(leaf_gap(self.grad0, grad0), leaf_gap(w["grad"], grads_w))
        return [("loss_gap", loss_gap, lim["loss_gap"]),
                ("image_rel_l1", image, lim["image_rel_l1"]),
                ("grad_gap", grad, lim["grad_gap"]),
                ("change_gap", max(leaf_gap(self.change, change),
                                   leaf_gap(w["change"], change_w)),
                 lim["change_gap"])]


def rel_l1(got, want) -> float:
    """The L1 gap of `got` to `want` over the L1 of `want`."""
    want = want.float()
    return float((got.float() - want).abs().sum()
                 / want.abs().sum().clamp_min(1e-30))


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's | |prog| - |ref| | over max(|ref leaf|, the median
    leaf's |ref|)."""
    norms = {p: float(ref[r].float().norm()) for p, r in LEAVES.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(prog[p].float().norm()) - norms[p])
               / max(norms[p], med, 1e-30) for p in LEAVES)


class RefAdam:
    """Bias-corrected Adam (Kingma and Ba), in the reference's own
    arithmetic."""

    def __init__(self, params, lr, beta_1, beta_2, epsilon):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.b1, self.b2, self.eps = lr, beta_1, beta_2, epsilon
        self.t = 0

    def resume(self, m: "pathtracer.Scene", v: "pathtracer.Scene", t: int):
        """Go on from moments m and v (held as a scene's reflectance and
        radiance rows) after t steps."""
        self.m = {"reflectance": m.reflectance, "radiance": m.radiance}
        self.v = {"reflectance": v.reflectance, "radiance": v.radiance}
        self.t = t

    def step(self, grads):
        self.t += 1
        lr_t = (self.lr * math.sqrt(1 - self.b2 ** self.t)
                / (1 - self.b1 ** self.t))
        for k in self.p:
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            self.p[k] = self.p[k] - lr_t * self.m[k] / (
                torch.sqrt(self.v[k]) + self.eps)
        return dict(self.p)
