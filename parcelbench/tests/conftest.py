"""Shared fixtures of the benchmark's CPU tests: the repository root on
``sys.path``, and the program's tables built once into a temporary cache
instead of the checkout's."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope='session')
def table_cache(tmp_path_factory):
    from parcelbench.harness import card
    path = str(tmp_path_factory.mktemp('parcelbench_cache'))
    before, card.CACHE_DIR = card.CACHE_DIR, path
    yield path
    card.CACHE_DIR = before

