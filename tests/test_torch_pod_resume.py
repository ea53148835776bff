"""A pod run of the port that stops: stopped at round 4, checkpointed by
rank 0 and restored on every rank, against the unbroken 8 rounds,
bitwise, for ring and for allgather, with a ``dropout`` fault
(``tests/test_service.py``'s ``POD_SCRIPT``; the reference's ring resume
is not bitwise, the port's must be), on four gloo ranks on the CPU, one
torch thread each, both exchanges in one spawned group
(``_torch_pod_ranks.resume_rank``); and a rank that raises, which stops
its group.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_pod_ranks as ranks  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """``resumed[rank][exchange]``: the unbroken and the resumed run."""
    return run_ranks(ranks.resume_rank, ranks.N,
                     str(tmp_path_factory.mktemp("ckpt")), threads=1,
                     timeout_s=120, join_timeout_s=300)


@pytest.mark.parametrize("exchange", ["ring", "allgather"])
def test_resume_is_bitwise_the_unbroken_run(resumed, exchange):
    for rank in range(ranks.N):
        res = resumed[rank][exchange]
        ranks.same_run(res["unbroken"], res["resumed"],
                       f"{exchange} rank {rank}")
    dropped = [m["dropped_fraction"]
               for m in resumed[0][exchange]["unbroken"]["metrics"]]
    assert any(d > 0 for d in dropped), "the dropout fault dropped no one"


def test_a_failing_rank_fails_the_group():
    """One rank that raises stops the others (blocked in a collective) and
    its traceback reaches the caller."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(ranks.raise_on_rank_one, 2, threads=1, timeout_s=60,
                  join_timeout_s=60)
