"""aho_corasick_1975_tpu — an accelerator-native multi-pattern matching
framework in JAX.

A from-scratch re-design of the capabilities of the C reference library
``farhiongit/aho-corasick-1975`` (generic-alphabet Aho–Corasick 1975 automaton
+ Meyer 1985 incremental insertion) for accelerators (NVIDIA GPUs):

* host-side builder collapses goto/fail/output into dense int32 tables
  (``core/``),
* the scan is a blocked gather recurrence compiled by XLA (``ops/``),
* corpora shard data-parallel over a ``jax.sharding.Mesh`` with halo handoff
  and psum-reduced match counts (``parallel/``),
* full reference API parity (``api.py``) plus conformance-tested semantics.

Quick start::

    import aho_corasick_1975_tpu as ac
    m = ac.Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    scanner = m.scanner()
    scanner.count("To ushers: he found his pencil ...")   # total matches
    scanner.find_matches("ushers")                         # (position, keyword)
"""

from .api import (ACM_CMP_DEFAULT, ACM_INCREMENTAL_STRING_MATCHING,
                  MatchHolder, acm_create, acm_foreach_keyword, acm_get_match,
                  acm_initiate, acm_insert_end_of_keyword,
                  acm_insert_letter_of_keyword, acm_match, acm_matcher_init,
                  acm_matcher_release, acm_nb_keywords, acm_print,
                  acm_release)
from .core.builder import Builder, DenseTables
from .models.bytes_machine import ByteMachine, UnicodeMachine
from .models.machine import Cursor, Machine, Match
from .models.results import MatchSet
from .models.scanner import DenseScanner, StreamSession
from .utils.checkpoint import (load_machine, load_tables, save_machine,
                               save_tables)
from .utils.config import MachineConfig, MeshConfig, ScanConfig

__version__ = "0.1.0"

__all__ = [
    "Machine", "Cursor", "Match", "MatchSet", "DenseScanner", "Builder",
    "DenseTables", "ByteMachine", "UnicodeMachine", "StreamSession",
    "save_machine", "load_machine", "save_tables", "load_tables",
    "MachineConfig", "ScanConfig", "MeshConfig",
    "acm_create", "acm_release", "acm_initiate",
    "acm_insert_letter_of_keyword", "acm_insert_end_of_keyword", "acm_match",
    "acm_matcher_init", "acm_get_match", "acm_matcher_release",
    "acm_nb_keywords", "acm_foreach_keyword", "acm_print", "MatchHolder",
    "ACM_CMP_DEFAULT", "ACM_INCREMENTAL_STRING_MATCHING", "__version__",
]
