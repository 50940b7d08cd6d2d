"""The benchmark's own tests of portbench/tests/test_portbench_oplsda.py, re-exported
so that tier-1, which collects tests/ alone, runs them too
(`python -m pytest portbench/tests` runs them where they live)."""

from portbench.tests.test_portbench_oplsda import *  # noqa: F401,F403
