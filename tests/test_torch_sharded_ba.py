"""Port parity of the edge-sharded BA (parallel/sharded_ba) on
torch.distributed: gloo groups of 2 and 4 ranks on the CPU against JAX's
sharded_run_ba on conftest's 4-device CPU mesh and against JAX's run_ba,
with and without reprojection edges (tests/test_sharded_ba.py's problems
and tolerances).

JAX's answers are computed here; the ranks are spawned through
parallel/launch.spawn (a file:// rendezvous under tmp_path, 60 s
collective and 300 s launch time limits) and run the port's
sharded_ba.run_rank, which imports no JAX, on the port's problem on CPU
tensors. Every rank returns its variables: they must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sage_slam_tpu.config import MapperConfig as JMapperConfig
from sage_slam_tpu.parallel import sharded_ba as jsb
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.parallel import launch
from sage_slam_tpu_torch.parallel import sharded_ba as tsb
from sage_slam_tpu_torch.parallel import sharded_store as tss
from sage_slam_tpu_torch.solver import ba as tba
from tests.test_ba import add_reproj_edges, build_problem, perturbed_vars

torch.set_num_threads(1)

K, CS, ITERS = 3, 4, 4
CASES = ("reproj", "plain")


def _jax_case(with_reproj: bool):
    problem, pyr = build_problem(k=K, cs=CS)
    if with_reproj:
        problem = add_reproj_edges(problem, pyr)
    cfg = JMapperConfig()
    v0 = perturbed_vars(K, CS)
    mask = jnp.ones(K)
    single = jba.run_ba(v0, problem, pyr, cfg, mask, max_iters=ITERS)
    mesh = JMesh(np.array(jax.devices()[:4]), (jsb.AXIS,))
    sharded = jsb.sharded_run_ba(v0, jsb.shard_problem(problem, mesh), pyr, cfg, mask, mesh,
                                 max_iters=ITERS)
    job = (
        convert.variables_from_numpy(jax.tree.map(np.asarray, v0), device="cpu"),
        convert.problem_from_numpy(jax.tree.map(np.asarray, problem), device="cpu"),
        convert.camera_pyramid_from_numpy(pyr), MapperConfig(), torch.ones(K), ITERS, False,
    )
    to_np = lambda out: (jax.tree.map(np.asarray, out[0]), float(out[1]), int(out[2]))  # noqa: E731
    return job, to_np(single), to_np(sharded)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's single and 4-device answers per case, and the port's per-rank
    results at 2 and 4 ranks."""
    cases = {name: _jax_case(name == "reproj") for name in CASES}
    jobs = [cases[name][0] for name in CASES]
    ports = {}
    for n in (2, 4):
        outs = launch.spawn(tsb.run_rank, n, jobs, devices=["cpu"] * n,
                            workdir=str(tmp_path_factory.mktemp(f"ranks{n}")))
        ports[n] = {name: [rank_out[i] for rank_out in outs] for i, name in enumerate(CASES)}
    return cases, ports


def _close(out, ref, label):
    """test_sharded_ba.py's tolerances: error rtol 1e-4 + atol 1e-6,
    translations and codes atol 1e-5 (rotations and scales too)."""
    v, err, _ = ref
    np.testing.assert_allclose(float(out["error"]), err, rtol=1e-4, atol=1e-6, err_msg=label)
    for name, want in (("trans", v.pose.trans), ("rot", v.pose.rot), ("code", v.code),
                       ("scale", v.scale)):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_run_ba_matches_jax(runs, n, case):
    """Each rank's result against JAX's 4-device sharded_run_ba and JAX's
    run_ba; the same iteration count; every rank's variables and error
    bit-equal to rank 0's; each rank holds its share of the padded photo
    edges."""
    cases, ports = runs
    _, single, sharded = cases[case]
    outs = ports[n][case]
    for rank, out in enumerate(outs):
        _close(out, sharded, f"{n} ranks, rank {rank} vs JAX sharded")
        _close(out, single, f"{n} ranks, rank {rank} vs JAX single")
        assert out["iterations"] == sharded[2] == single[2]
        assert out["photo_edges"] == -(-2 * (K - 1) // n)
        for name in ("rot", "trans", "code", "scale", "error"):
            assert torch.equal(out[name], outs[0][name]), f"rank {rank} {name}"


def test_reprojection_term_is_in_the_sharded_cost(runs):
    """test_sharded_ba.py:53-60: dropping the reprojection edges changes
    the sharded result (so the term is in the cost), at each rank count."""
    _, ports = runs
    for n in (2, 4):
        err_with = float(ports[n]["reproj"][0]["error"])
        err_without = float(ports[n]["plain"][0]["error"])
        assert abs(err_with - err_without) > 1e-8


def test_pad_edges():
    e = tba.EdgeTable(torch.tensor([0, 1, 2]), torch.tensor([1, 2, 0]), torch.ones(3))
    p = tsb.pad_edges(e, 4)
    assert p.i0.shape[0] == 4 and float(p.valid[3]) == 0.0
    assert tsb.pad_edges(e, 3) is e
    je = jba.EdgeTable(jnp.asarray([0, 1, 2], jnp.int32), jnp.asarray([1, 2, 0], jnp.int32),
                       jnp.ones(3))
    jp = jsb.pad_edges(je, 4)
    for a, b in zip(p, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    problem = add_reproj_edges(*build_problem(k=K, cs=CS))
    re = convert.problem_from_numpy(jax.tree.map(np.asarray, problem), device="cpu").reproj_edges
    padded = tsb.pad_reproj_edges(re, 3)
    jpadded = jsb.pad_reproj_edges(problem.reproj_edges, 3)
    assert padded.i0.shape[0] == 6
    for a, b in zip(padded, jpadded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dryrun_2_ranks(tmp_path):
    """dryrun(2): one sharded step on the JAX dryrun's tiny problem, a
    finite error, the two ranks bit-equal; the same step on one process
    (run_ba) agrees."""
    outs = tsb.dryrun(2, devices=["cpu"] * 2, workdir=str(tmp_path))
    assert np.isfinite(outs[0]["error"]) and outs[0]["iterations"] == 2
    assert outs[0]["error"] == outs[1]["error"]
    assert torch.equal(outs[0]["trans"], outs[1]["trans"])
    assert (outs[0]["device"], outs[0]["backend"]) == ("cpu", "gloo")
    v, problem, pyr = tsb.dryrun_problem(torch.device("cpu"))
    v1, err1, it1, _ = tba.run_ba(v, problem, pyr, MapperConfig(), torch.ones(4), max_iters=2)
    assert it1 == 2
    np.testing.assert_allclose(outs[0]["error"], float(err1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(outs[0]["trans"].numpy(), v1.pose.trans.numpy(), atol=1e-5)


@pytest.mark.parametrize("entry", ["sharded_ba.dryrun", "sharded_store.dryrun", "spawn",
                                   "one_rank"])
def test_entry_points_refuse_a_silent_cpu_fallback(entry, tmp_path):
    """The multi-device entry points put their ranks on the card unless
    the caller names the CPU: without CUDA they raise before any rank
    starts."""
    calls = {
        "sharded_ba.dryrun": lambda: tsb.dryrun(2, workdir=str(tmp_path)),
        "sharded_store.dryrun": lambda: tss.dryrun(2, workdir=str(tmp_path)),
        "spawn": lambda: launch.spawn(tsb.run_rank, 2, workdir=str(tmp_path)),
        "one_rank": lambda: launch.one_rank(workdir=str(tmp_path)).__enter__(),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not torch.distributed.is_initialized()


def test_rank_devices_and_backends():
    """Explicit devices pass through; a list of the wrong length is
    refused; NCCL only when every rank has a card of its own."""
    assert launch.rank_devices(2, ["cpu", "cpu"]) == ["cpu", "cpu"]
    with pytest.raises(ValueError):
        launch.rank_devices(3, ["cpu", "cpu"])
    assert launch.default_backend(["cpu", "cpu"]) == "gloo"
    assert launch.default_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert launch.default_backend(["cuda:0", "cuda:1"]) == "nccl"


def test_one_rank_beside_an_existing_group(tmp_path):
    """In a process that already has a default group, one_rank makes a
    group of its own and leaves the default one in place; a group of one
    sums without a collective, returning the tensors themselves."""
    import datetime

    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'default'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with launch.one_rank("cpu", workdir=str(tmp_path)) as mesh:
            assert mesh.group is not None and mesh.size == 1 and mesh.rank == 0
            h, b = torch.ones(3, 3), torch.arange(3.0)
            out = mesh.all_reduce(h, b)
            assert out[0] is h and out[1] is b
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
