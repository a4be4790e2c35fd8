"""Multi-process chunk distribution: shard + merge determinism.

Two simulated hosts split the -K chunk stream round-robin
(parallel/distributed.py); the merged SAM must be byte-identical to a
single-process run — the cross-host extension of the reference's -K
reproducibility contract (main.cpp:266,437).
"""

import os

from tests.conftest import FIXTURES


def _mem(argv, env):
    from compseed import cli
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = cli.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0


def test_two_process_shard_merge(tmp_path):
    idx = os.path.join(FIXTURES, "tiny")
    fq = os.path.join(FIXTURES, "reads.fq")
    single = str(tmp_path / "single.sam")
    # -K forces several chunks so both processes own some
    _mem(["mem", "-K", "30000", idx, fq, "-o", single],
         {"COMPSEED_NPROCS": ""})

    merged = str(tmp_path / "dist.sam")
    for pid in ("0", "1"):
        _mem(["mem", "-K", "30000", idx, fq, "-o", merged],
             {"COMPSEED_NPROCS": "2", "COMPSEED_PROC_ID": pid})
    shards = [p for p in os.listdir(tmp_path)
              if p.startswith("dist.sam.shard")]
    assert len(shards) >= 2          # both processes produced output
    _mem(["merge", merged], {})

    a = [l for l in open(single) if not l.startswith("@PG")]
    b = [l for l in open(merged) if not l.startswith("@PG")]
    assert a == b
