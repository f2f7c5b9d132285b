"""Faults planted under the timed path, for the benchmark's own tests and
its controls: each takes the program's entry points
(entries/common.program_api) and returns a copy with one of them broken
as the fault says. A sound check reads each of them as not correct."""
from __future__ import annotations

import types


def stale_state(api):
    """A step that returns its state unchanged: Adam hands back the
    tables and moments it was given."""
    def adam_step(params, grads, state, **kw):
        return params, state
    return types.SimpleNamespace(**{**vars(api), "adam_step": adam_step})


def half_batch(api):
    """Half of the batch left out, the mean taken over the rest: each
    render and gradient from the first half of its samples."""
    def half(config):
        return config.replace(spp=config.spp // 2,
                              spp_per_pass=config.spp_per_pass // 2)

    def render(scene, config, *a, **kw):
        return api.render(scene, half(config), *a, **kw)

    def render_l2_grad(scene, config, *a, **kw):
        return api.render_l2_grad(scene, half(config), *a, **kw)
    return types.SimpleNamespace(**{**vars(api), "render": render,
                                    "render_l2_grad": render_l2_grad})


def altered(api):
    """An answer altered where it is produced: an image 0.1% too bright,
    a gradient 20% too large."""
    def render(*a, **kw):
        return api.render(*a, **kw) * 1.001

    def render_l2_grad(*a, **kw):
        img, loss, grads = api.render_l2_grad(*a, **kw)
        return img, loss, {k: g * 1.2 for k, g in grads.items()}
    return types.SimpleNamespace(**{**vars(api), "render": render,
                                    "render_l2_grad": render_l2_grad})


# the faults each entry's cells can have
FAULTS = {"render": {"half_batch": half_batch, "altered": altered},
          "grad_step": {"stale_state": stale_state,
                        "half_batch": half_batch, "altered": altered}}
