"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``."""
