"""Seconds of the scene's build and upload (mt.build_scene: the host
BVH, the cluster cut, the tables on the device), timed by the harness:
a part of setup_s."""


def read(ctx):
    return ctx.scene_build_s
