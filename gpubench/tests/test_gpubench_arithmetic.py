"""The frozen yardstick on hand-worked shapes: counted rays, the walk's
bytes, and the reduction of a trace to busy time, idle gaps and device
time by name."""
import re

from gpubench import peaks, profile, raycount


def _t(entry="render", w=256, h=256, spp=16, depth=3):
    return {"entry": entry, "width": w, "height": h, "spp": spp,
            "spp_per_pass": spp, "max_depth": depth}


def test_counted_rays():
    # bench.py's count: 256 x 256 x 16 lanes, a camera ray and two rays a
    # bounce at depth 3: 1 048 576 x 5
    assert raycount.rays_per_pass(_t()) == 5_242_880
    # the cells: 2^24 lanes a pass
    assert raycount.rays_per_frame(_t(w=1024, h=1024)) == 83_886_080
    assert raycount.rays_per_frame(_t(w=512, h=512, spp=64, depth=4)) \
        == 117_440_512
    assert raycount.rays_per_frame(
        _t("grad_step", 512, 512, 64, 4)) == 234_881_024
    assert raycount.rays_per_frame(
        _t("grad_step", 1024, 1024, 16, 3)) == 167_772_160


def test_walk_bytes_by_hand():
    # 2 x 2 x 1 lanes at depth 2: one camera and one bounce closest hit,
    # one shadow any hit; 10 triangles of 36 bytes read by each
    t = _t(w=2, h=2, spp=1, depth=2)
    assert raycount.traversal_launches(t) == (2, 1)
    closest = 4 * (28 + 16) + 10 * 36
    any_ = 4 * (28 + 1) + 10 * 36
    assert raycount.walk_bytes(t, 10) == 2 * closest + any_
    # a gradient step walks twice: the forward and the adjoint's replay
    g = dict(t, entry="grad_step")
    assert raycount.walk_bytes(g, 10) == 2 * raycount.walk_bytes(t, 10)


def test_gallery_render_bound():
    # 3 closest and 2 any hits of 2^24 lanes, 30 732 triangles: 3.19 GB,
    # 0.95 ms at the data sheet's 3.35 TB/s
    b = raycount.walk_bytes(_t(w=1024, h=1024), 30_732)
    assert b == (3 * (2**24 * 44 + 30_732 * 36)
                 + 2 * (2**24 * 29 + 30_732 * 36))
    assert abs(b / peaks.HBM_BYTES_PER_S - 0.000952) < 2e-6


def _trace():
    w = (1000, 2000)
    ops = [("k_closest_hit_a", 1000, 1100), ("add", 1050, 1300),
           ("Memcpy HtoD", 1400, 1500), ("k_any_hit_b", 1700, 1900),
           ("add", 1950, 2100)]
    cpu = [(profile.WINDOW, 1000, 2000), ("gpubench.render", 1000, 1600),
           ("aten::nonzero", 1300, 1390), ("gpubench.adam_step", 1600, 2000)]
    return profile.Trace(ops=ops, cpu=cpu, window=w, frames=2)


def test_busy_and_gaps():
    tr = _trace()
    # busy [1000, 1300), [1400, 1500), [1700, 1900), [1950, 2000)
    assert abs(profile.busy_s(tr) - 650e-9) < 1e-15
    gaps = profile.idle_gaps(tr)
    assert [round(g[1] * 1e9) for g in gaps] == [200, 100, 50]
    assert [g[0] for g in gaps] == ["render: python",
                                    "render: aten::nonzero",
                                    "adam_step: python"]
    assert abs(tr.window_s - 1000e-9) < 1e-15


def test_device_time_by_name():
    tr = _trace()
    assert len(tr.kernels) == 4
    assert abs(profile.device_seconds(tr, profile.WALK) - 300e-9) < 1e-15
    top = profile.top_ops(tr)
    assert top[0][0] == "add" and abs(top[0][1] - 400e-9) < 1e-15
    assert profile.WALK.search(
        "(anonymous namespace)::cluster_closest_hit_kernel(float4 const*)")
    assert not profile.WALK.search("vectorized_elementwise_kernel")
    assert re.match(profile.COPY, "Memset (Device)")
