"""Port parity of the keyframe-sharded mapping step (parallel/sharded_store)
on torch.distributed: gloo groups of 2 and 4 ranks on the CPU against JAX's
sharded_window_run_ba on conftest's CPU mesh and against the single-device
compact run_ba (tests/test_sharded_store.py's problem and tolerances), and
the per-rank store bytes at 1/n of the replicated tables.

The ranks are spawned through parallel/launch.spawn (a file:// rendezvous
under tmp_path, 60 s collective and 300 s launch time limits) and run the
port's sharded_store.run_rank; every rank's variables must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sage_slam_tpu.config import MapperConfig as JMapperConfig
from sage_slam_tpu.parallel import sharded_store as jss
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.parallel import launch
from sage_slam_tpu_torch.parallel import sharded_store as tss
from sage_slam_tpu_torch.solver import ba as tba
from tests.test_ba import build_problem, perturbed_vars

torch.set_num_threads(1)

K, CS, ITERS = 6, 4, 3
IDS = [1, 2, 3, 4]  # a window strictly inside the map
PAIRS = [(1, 2), (2, 1), (2, 3), (3, 2), (3, 4), (4, 3)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    problem, pyr = build_problem(k=K, cs=CS)
    problem = jba.prepare_problem(problem, pyr)
    cfg = JMapperConfig()
    v0 = perturbed_vars(K, CS)
    ids = jnp.asarray(IDS, jnp.int32)
    pad_valid = jnp.ones(len(IDS))
    id_map = {kf: c for c, kf in enumerate(IDS)}
    edges = jba.EdgeTable(
        i0=jnp.asarray([id_map[a] for a, _ in PAIRS], jnp.int32),
        i1=jnp.asarray([id_map[b] for _, b in PAIRS], jnp.int32),
        valid=jnp.ones(len(PAIRS)),
    )
    pr = problem.priors
    priors_c = jax.tree.map(lambda x: x[ids], pr)
    umask = jnp.ones(len(IDS)).at[0].set(0.0)  # one frozen row
    compact = jba.compact_problem_keyframes(problem, ids, pad_valid, pyr)
    ref = jba.run_ba(jax.tree.map(lambda x: x[ids], v0),
                     compact._replace(photo_edges=edges, geo_edges=edges, priors=priors_c),
                     pyr, cfg, umask, max_iters=ITERS)
    jax_out = {}
    for n in (2, 4):
        mesh = JMesh(np.array(jax.devices()[:n]), (jss.AXIS,))
        win = jss.shard_window(problem.window, mesh)
        jax_out[n] = jss.sharded_window_run_ba(v0, win, edges, edges, None, priors_c, ids, pad_valid,
                                               umask, pyr, cfg, mesh, max_iters=ITERS)
    tp = convert.problem_from_numpy(jax.tree.map(np.asarray, problem), device="cpu")
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    tedges = tba.EdgeTable(torch.tensor(np.asarray(edges.i0), dtype=torch.int64),
                           torch.tensor(np.asarray(edges.i1), dtype=torch.int64), t(edges.valid))
    tpr = tp.priors
    tids = torch.tensor(IDS)
    job = (
        convert.variables_from_numpy(jax.tree.map(np.asarray, v0), device="cpu"), tp.window,
        tedges, tedges, None,
        tba.PriorTable(tpr.code_valid[tids], tpr.scale_valid[tids], tpr.scale_init[tids],
                       tpr.pose_valid[tids],
                       type(tpr.pose_target)(tpr.pose_target.rot[tids], tpr.pose_target.trans[tids])),
        tids, torch.ones(len(IDS)), t(umask), convert.camera_pyramid_from_numpy(pyr),
        MapperConfig(), ITERS,
    )
    ports = {n: launch.spawn(tss.run_rank, n, [job], devices=["cpu"] * n,
                             workdir=str(tmp_path_factory.mktemp(f"ranks{n}")))
             for n in (2, 4)}
    to_np = lambda out: (jax.tree.map(np.asarray, out[0]), float(out[1]), int(out[2]))  # noqa: E731
    return (to_np(ref), {n: to_np(o) for n, o in jax_out.items()},
            {n: [o[0] for o in outs] for n, outs in ports.items()}, v0, tp.window)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_window_step_matches_jax_and_single(runs, n):
    """Against JAX's keyframe-sharded step on an n-device mesh and the
    single-device compact run_ba (test_sharded_store.py:64-81: error rtol
    5e-4 + atol 1e-6, translations and scales rtol 1e-4 + atol 1e-6); rows
    outside the compact set keep their input values; every rank's
    variables and error bit-equal to rank 0's."""
    ref, jax_out, ports, v0, _ = runs
    sel = np.asarray(IDS)
    for rank, out in enumerate(ports[n]):
        for label, (v, err, iters) in (("JAX sharded", jax_out[n]), ("single compact", ref)):
            full = label == "JAX sharded"
            msg = f"{n} ranks, rank {rank} vs {label}"
            np.testing.assert_allclose(float(out["error"]), err, rtol=5e-4, atol=1e-6, err_msg=msg)
            assert out["iterations"] == iters, msg
            for name, want in (("trans", v.pose.trans), ("scale", v.scale), ("code", v.code)):
                want = np.asarray(want)[sel] if full else np.asarray(want)
                np.testing.assert_allclose(out[name].numpy()[sel], want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{msg} {name}")
        for row in (0, 5):
            np.testing.assert_array_equal(out["trans"][row].numpy(), np.asarray(v0.pose.trans[row]))
        for name in ("rot", "trans", "code", "scale", "error"):
            assert torch.equal(out[name], ports[n][0][name]), f"rank {rank} {name}"


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_window_memory_scales_down(runs, n):
    """Each rank's shard of the big tables is 1/n of the (padded) whole
    (test_sharded_window_memory_scales_down), and its bytes equal
    store_bytes_per_device's share; the accounting matches JAX's."""
    _, _, ports, _, window = runs
    kp = -(-K // n) * n
    acct = tss.store_bytes_per_device(window, n)
    for out in ports[n]:
        for name in ("feat_pyr", "grad_pyr", "packed_fg", "bias_flat"):
            whole = window.tables.packed_fg if name == "packed_fg" else getattr(window, name)
            assert out["shard_numel"][name] * n == whole.numel() * kp // K, name
        assert out["accounting"] == acct
        assert out["local_bytes"] * n == acct["replicated_bytes"] * kp // K
    problem, pyr = build_problem(k=8, cs=CS)
    jwin = jba.prepare_problem(problem, pyr).window
    twin = tba.prepare_problem(convert.problem_from_numpy(jax.tree.map(np.asarray, problem),
                                                          device="cpu"), convert.camera_pyramid_from_numpy(pyr)).window
    tacct = tss.store_bytes_per_device(twin, 8)
    jacct = jss.store_bytes_per_device(jwin, 8)
    # the port's ids are int64 where JAX's are int32, and the port's window
    # carries the prep kernel's pixel rows, which JAX's lacks
    extra = twin.loc1d.numel() * 4 + twin.tables.pixel_fg.numel() * 4
    assert tacct["replicated_bytes"] - jacct["replicated_bytes"] == extra
    assert tacct["sharded_bytes_per_device"] <= tacct["replicated_bytes"] // 7


def test_dryrun_2_ranks(tmp_path):
    """dryrun(2): one keyframe-sharded step on tiny shapes, a finite error,
    the two ranks bit-equal."""
    outs = tss.dryrun(2, devices=["cpu"] * 2, workdir=str(tmp_path))
    assert np.isfinite(outs[0]["error"]) and outs[0]["iterations"] == 2
    assert outs[0]["error"] == outs[1]["error"]
    assert torch.equal(outs[0]["trans"], outs[1]["trans"])
    assert (outs[0]["device"], outs[0]["backend"]) == ("cpu", "gloo")
