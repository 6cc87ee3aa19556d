"""Multi-GPU rendering (``parallel/mesh.py`` on ``torch.distributed``) on
the CPU: gloo ranks, each a process of its own with one torch thread,
against the port's single render and against the JAX package
(``tests/test_multichip.py`` and ``tests/test_distributed.py``'s
counterparts).

- the toy scene (``__graft_entry__._build``) at 16x64, 2 spp, over 2, 4
  and 8 ranks: the gathered frame bit-equal to the port's single render
  in all five image fields, and both trace totals equal;
- the port's single render against the JAX package's ``render_samples``:
  trace counts under the ladder's gate (they are equal), RMSE < 2e-4;
  the share of pixels within 1e-5 is 59.5 %, under the ladder's 98 % and
  the mixed scene's 80 %: the roughness-0.2 metal sphere (ROADMAP Queue
  3, "GGX below roughness ~0.3"), so the share is gated at 50 %;
- height 67 over 8 ranks: padded to 72, the unpadded frame bit-equal to
  the single render, the totals equal to the JAX package's
  ``render_samples_sharded`` on conftest's 8 virtual devices, pad rows
  included. The JAX call keeps the default chunk: with
  ``test_multichip.py``'s ``chunk=width * 8`` its last chunk is padded
  to 128 lanes and the padding's traces count too (8,827 against 4,907
  over the 72 rows);
- the bench-class scene (``_build_full``'s counterpart) at 24x32 over 8
  ranks, bit-equal to the single render;
- the two-process ``parallel.dryrun`` over a TCP init;
- ``shard_state`` of a pre-sq_sum state; ``make_mesh`` without a
  process group, and asked for a card where there is none.

Three rank launches (2, 4 and 8 ranks), each running all of its world
size's cases; two JAX renders.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__
from metal_pathtracer_tpu.parallel import mesh as jax_mesh
from metal_pathtracer_tpu.renderer import frame as jax_frame
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu_torch.parallel import dryrun
from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPP = 2
#: world size -> the cases its launch runs, (scene, width, height)
CASES = {2: [("toy", 16, 64)], 4: [("toy", 16, 64)],
         8: [("toy", 16, 64), ("toy", 16, 67), ("bench", 24, 32)]}

#: one rank of a launch: every case of its world size, rank 0 saving
#: each gathered frame
RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from metal_pathtracer_tpu_torch.parallel import dryrun
    from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops
    torch.set_num_threads(1)
    init, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    mesh = mesh_ops.make_mesh(device="cpu")
    for case in sys.argv[5:]:
        name, w, h = case.split(":")
        res = dryrun.check_case(
            mesh, *dryrun.build_scene(name, int(w), int(h), "cpu"), %d)
        print(f"{name}_{w}x{h} padded={res['padded']}")
        if rank == 0:
            dryrun.save_state(f"{out}/{name}_{w}x{h}.npz", res["state"])
    dist.destroy_process_group()
    print(f"RANK_OK {rank}")
""" % SPP)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, out: str):
    """``world`` rank processes over a TCP init; returns their outputs.
    The two-rank launch goes through ``python -m ...parallel.dryrun``."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(world):
        if world == 2:
            cmd = ["-m", "metal_pathtracer_tpu_torch.parallel.dryrun",
                   "--backend", "gloo", "--init-method", init,
                   "--world-size", "2", "--rank", str(rank), "--device",
                   "cpu", "--scene", "toy", "--width", "16", "--height",
                   "64", "--spp", str(SPP), "--out",
                   os.path.join(out, "toy_16x64.npz")]
        else:
            cmd = ["-c", RANK, init, str(world), str(rank), out] + [
                f"{n}:{w}:{h}" for n, w, h in CASES[world]]
        procs.append(subprocess.Popen(
            [sys.executable, *cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{text}"
    return outs


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Every launch's gathered frames (rank 0's ``.npz``) and outputs."""
    runs = {}
    for world in CASES:
        out = str(tmp_path_factory.mktemp(f"world{world}"))
        texts = _launch(world, out)
        runs[world] = dict(texts=texts, frames={
            (n, w, h): dict(np.load(os.path.join(out, f"{n}_{w}x{h}.npz")))
            for n, w, h in CASES[world]})
    return runs


def _single(name, w, h, rows=None):
    """The port's single-process render (over ``rows`` rows with the
    ``h``-row image's camera when given)."""
    scene, uni, static = dryrun.build_scene(name, w, h, "cpu")
    return frame.render_samples(scene, uni,
                                RenderState.create(w, rows or h, "cpu"),
                                static, SPP)


def _assert_frame_equal(got: dict, want: RenderState):
    for f in mesh_ops.IMAGE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(),
                                      err_msg=f)
    assert int(got["ray_count"]) == want.ray_count
    assert int(got["shadow_ray_count"]) == want.shadow_ray_count


@pytest.fixture(scope="module")
def toy():
    """The port's toy render at 16x64 and the JAX package's."""
    scene, uni, static = __graft_entry__._build(16, 64)
    ref = jax_frame.render_samples(scene, uni, JState.create(16, 64), static,
                                   SPP)
    return _single("toy", 16, 64), ref


@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_matches_single(launches, toy, world):
    _assert_frame_equal(launches[world]["frames"][("toy", 16, 64)], toy[0])


def test_single_render_against_jax(toy):
    port, ref = toy
    rays = float(np.asarray(ref.ray_count))
    assert abs(port.ray_count - rays) <= max(4.0, 1e-4 * rays)
    assert port.shadow_ray_count == int(np.asarray(ref.shadow_ray_count))
    d = np.abs(port.present().numpy() - np.asarray(ref.present()))
    assert float(np.sqrt((d * d).mean())) < 2e-4
    within = float((d.max(-1) < 1e-5).mean())
    assert within > 0.5, within
    for f in ("sample_count", "albedo"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_padded_height_matches_single_and_jax_totals(launches):
    got = launches[8]["frames"][("toy", 16, 67)]
    assert got["radiance_sum"].shape[0] == 67
    assert "toy_16x67 padded=72" in launches[8]["texts"][0]
    single = _single("toy", 16, 67)
    for f in mesh_ops.IMAGE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(single, f).numpy(),
                                      err_msg=f)
    padded = _single("toy", 16, 67, rows=72)
    assert int(got["ray_count"]) == padded.ray_count > single.ray_count
    scene, uni, static = __graft_entry__._build(16, 67)
    import jax
    mesh = jax_mesh.make_mesh(jax.devices()[:8])
    ref = jax_mesh.render_samples_sharded(
        jax_mesh.replicate(scene, mesh), jax_mesh.replicate(uni, mesh),
        jax_mesh.shard_state(JState.create(16, 67), mesh), static, SPP,
        mesh)
    assert int(got["ray_count"]) == int(np.asarray(ref.ray_count))
    assert int(got["shadow_ray_count"]) == \
        int(np.asarray(ref.shadow_ray_count))


def test_bench_class_scene_over_8_ranks(launches):
    got = launches[8]["frames"][("bench", 24, 32)]
    single = _single("bench", 24, 32)
    _assert_frame_equal(got, single)
    assert single.shadow_ray_count > 0   # the environment's NEE ran


def test_two_process_dryrun(launches):
    for rank, text in enumerate(launches[2]["texts"]):
        assert f"DIST_DRYRUN_OK rank={rank} world=2" in text, text


def test_shard_state_of_a_pre_sq_sum_state():
    base = RenderState.create(3, 5, "cpu")
    state = base.replace(
        radiance_sum=torch.arange(45, dtype=torch.float32).reshape(5, 3, 3),
        radiance_sq_sum=None)
    mesh = mesh_ops.Mesh(rank=1, world_size=2, device=torch.device("cpu"),
                         group=None,
                         collective_device=torch.device("cpu"))
    slab = mesh_ops.shard_state(state, mesh)
    assert slab.height == 3
    np.testing.assert_array_equal(slab.radiance_sum[:2].numpy(),
                                  state.radiance_sum[3:].numpy())
    assert not slab.radiance_sum[2].any()
    assert slab.radiance_sq_sum is not None
    assert not slab.radiance_sq_sum.any()
    whole = mesh_ops.unpad_state(slab.replace(radiance_sq_sum=None), 2)
    assert whole.height == 2 and whole.radiance_sq_sum is None


def test_make_mesh_needs_a_group_and_a_card_for_cuda():
    if dist.is_initialized():
        pytest.fail("a process group is already initialised")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_ops.make_mesh(device="cpu")
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_ops.make_mesh(device="cpu")
        assert (mesh.rank, mesh.world_size) == (0, 1)
        assert mesh.collective_device == torch.device("cpu")
        if not torch.cuda.is_available():
            for device in (None, "cuda:0"):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    mesh_ops.make_mesh(device=device)
    finally:
        dist.destroy_process_group()
