"""The port's Trainer on 4 gloo ranks against one process at the global
batch of 4, as in tests/test_torch_parallel_train.py, all in one process
group: HSDP (data 2 x fsdp 2, `fsdp_min_size` 4096, one row per rank, as
the JAX package's tests/test_fsdp_multiprocess.py shards), FSDP over all 4
ranks, and the compositions with tensor parallelism, fsdp 2 x tensor 2 (as
the JAX package's tests/test_training.py composes fsdp and tensor) and data
2 x tensor 2. Per-rank bytes of parameters, optimizer state and EMA must be
under 0.5 of the replicated total with fsdp = 4 and under 0.6 with fsdp =
2 (tests/test_fsdp.py holds JAX's so), and under 0.45 with fsdp 2 x tensor
2.
"""

import pytest

from tests.test_torch_parallel_train import VALIDATE, check_against_reference, reference  # noqa: F401
from tests.torch_parallel_worker import spawn

HSDP = dict(mesh=dict(data=2, fsdp=2), use_fsdp=True, fsdp_min_size=4096, train_batch_size=1)
CASES = {
    "fsdp4": dict(mesh=dict(data=1, fsdp=4), use_fsdp=True, fsdp_min_size=4096,
                  train_batch_size=1),
    "fsdp2_tensor2": dict(mesh=dict(data=1, fsdp=2, tensor=2), use_fsdp=True,
                          use_tensor_parallel=True, fsdp_min_size=4096, train_batch_size=2),
    "data2_tensor2": dict(mesh=dict(data=2, tensor=2), use_tensor_parallel=True,
                          train_batch_size=2),
}
BATCH_RANKS = {"fsdp4": [0, 1, 2, 3], "fsdp2_tensor2": [0, 0, 1, 1], "data2_tensor2": [0, 0, 1, 1]}
# fsdp 2 x tensor 2 under fsdp = 2 alone's 0.6: the blocks' projections are
# cut over both axes
MAX_BYTES = {"fsdp4": 0.5, "fsdp2_tensor2": 0.45, "data2_tensor2": 0.8}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):  # noqa: F811
    """HSDP and the cases one after another in one group of 4 gloo
    processes: {case: (each rank's results, its work dir)}."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    root = reference[0]
    names = ["hsdp"] + sorted(CASES)
    runs = [dict(kind="trainer", data_root=root, work_dir=str(tmp / name), steps=3,
                 config=dict(CASES.get(name, HSDP), **VALIDATE)) for name in names]
    got = spawn(tmp, 4, runs)
    return {name: ([r[i] for r in got], str(tmp / name)) for i, name in enumerate(names)}


def test_hsdp_on_four_ranks_matches_one_process(reference, ranks):  # noqa: F811
    hsdp, work = ranks["hsdp"]
    check_against_reference(hsdp, reference, work)
    assert [r["batch_rank"] for r in hsdp] == [0, 1, 2, 3]
    for r in hsdp:
        assert r["bytes"] < 0.6 * r["total_bytes"], r["bytes"] / r["total_bytes"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_ranks_match_one_process_at_the_global_batch(case, reference, ranks):  # noqa: F811
    got, work = ranks[case]
    check_against_reference(got, reference, work)
    assert [r["batch_rank"] for r in got] == BATCH_RANKS[case]
    for r in got:
        assert r["bytes"] < MAX_BYTES[case] * r["total_bytes"], r["bytes"] / r["total_bytes"]
    if case == "fsdp4":
        assert got[0]["bytes"] < min(r["bytes"] for r in ranks["hsdp"][0])
