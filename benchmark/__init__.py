"""The benchmark of ``ratis_tpu_torch`` (``BENCHMARK.json`` at the
repository's root names its cells and metrics).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Found by name: ``configs/<config>.json`` (one deployment: its Raft keys,
servers, groups, state machine, guarantees), ``traffic/<mix>.json`` (one
traffic mix, read by ``generator.py``), ``deployments/<kind>.py`` (how a
deployment starts), ``metrics/<metric>.py`` (one per-layer metric's
reader).  ``reference/`` is the plain reference that decides
``correct``; ``controls.py`` the control it has to fail; ``tests/`` the
harness's own tests (``python -m pytest benchmark/tests``).
"""
