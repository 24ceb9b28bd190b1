"""scene_update_ms: mean host time a frame of refit_mesh_instance and
Renderer.set_scene, ended by a synchronise (traced runs only)."""


def read(ctx):
    spans = ctx.window.spans["scene_update"]
    return 1e3 * sum(spans) / len(spans) if spans else None
