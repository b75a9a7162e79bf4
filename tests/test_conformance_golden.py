"""Golden conformance: the reference README demo, byte-for-byte.

Replays examples/test.c (== README.md:61-94) through both the host streaming
API and the device dense-scan path, and asserts the exact golden output line
(README.md:92-93):

    `` 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers``

Positions are 1-based keyword starts (i + 2 - length, test.c:20); at each end
position the demo enumerates match index nb-1..0, i.e. shortest -> longest,
while the API itself orders index 0 = longest (SURVEY.md §2b).
"""

import itertools

import pytest

import aho_corasick_1975_tpu as ac

WORDS = ["he", "she", "his", "hers"]
TEXT = "To ushers: he found his pencil, but she could not find hers."
GOLDEN = " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"


def build_machine(incremental):
    m = ac.Machine(incremental=incremental)
    for w in WORDS:
        cur = m.initiate()
        for ch in w:
            m.insert_letter_of_keyword(cur, ch)
        m.insert_end_of_keyword(cur)
    return m


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["meyer85", "ac75"])
def test_streaming_host_path(incremental):
    m = build_machine(incremental)
    cur = m.initiate()
    out = []
    for i, ch in enumerate(TEXT):
        for j in range(m.match(cur, ch), 0, -1):
            match = m.get_match(cur, j - 1)
            out.append(f" {i + 2 - match.length}:{match.text()}")
    assert "".join(out) == GOLDEN


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["meyer85", "ac75"])
def test_dense_scanner_path(incremental):
    m = build_machine(incremental)
    scanner = m.scanner(n_streams=4)  # tiny stream count: forces real blocking
    events = scanner.find_matches(TEXT)
    # Regroup by end position and emit shortest-first within each, as test.c
    # does (index nb-1 .. 0).
    out = []
    for _, group in itertools.groupby(events, key=lambda em: em[0].end):
        for ev, match in reversed(list(group)):
            out.append(f" {ev.start + 1}:{match.text()}")
    assert "".join(out) == GOLDEN
    assert scanner.count(TEXT) == 9


def test_functional_api_shim():
    """Same demo through the acm_* functional shim (reference symbol names)."""
    machine = ac.acm_create()
    state = ac.acm_initiate(machine)
    for w in WORDS:
        for ch in w:
            ac.acm_insert_letter_of_keyword(state, ch)
        ac.acm_insert_end_of_keyword(state)
    matcher = ac.acm_matcher_init()
    cst = ac.acm_initiate(machine)
    out = []
    for i, ch in enumerate(TEXT):
        for j in range(ac.acm_match(cst, ch), 0, -1):
            ac.acm_get_match(cst, j - 1, matcher)
            out.append(f" {i + 2 - matcher[0].length}:{matcher[0].text()}")
    assert "".join(out) == GOLDEN
    assert ac.acm_nb_keywords(machine) == 4
    ac.acm_matcher_release(matcher)
    ac.acm_release(machine)


def test_empty_dictionary_matches_nothing():
    """Matching with an empty dictionary returns 0
    (ref generic_test.c:70)."""
    m = ac.Machine()
    cur = m.initiate()
    assert m.match(cur, "a") == 0
    # Dense path: empty automaton is a single root state.
    scanner = m.scanner()
    assert scanner.count("anything at all") == 0
    assert scanner.find_matches("abc") == []
