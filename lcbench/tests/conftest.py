"""CPU tests of the benchmark harness: run them with

    python -m pytest lcbench/tests -q

The repository's own test command (`pytest tests/`) does not collect them.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
