"""Paper-graph test: reference generic_test Test 1 semantics.

Mirrors examples/aho_corasick_generic_test.c:63-164 — the automaton from the
original Aho–Corasick paper plus adversarial extensions: 26 insertions, 21
distinct keywords (duplicates hers/hen/pen/bcd/abcde), the duplicate-insert
return-value protocol with the CHECK/SUM "user defined appender" contract
(generic_test.c:109-119), case-insensitive matching (alphacmp,
generic_test.c:48-54), keyword enumeration, and the trie dump.
"""

import io

import pytest

import aho_corasick_1975_tpu as ac

# (keyword, CHECK: 1 iff first insertion, SUM: accumulated value), in the
# reference's exact insertion order (generic_test.c:73-99).
LIST_OF_KEYWORDS = [
    ("he", 1, 0), ("she", 1, 1), ("sheers", 1, 2), ("his", 1, 3),
    ("hi", 1, 4), ("hers", 1, 5), ("ushers", 1, 6), ("abcde", 1, 7),
    ("bcd", 1, 8), ("hers", 0, 14), ("hen", 1, 10), ("hen", 0, 21),
    ("bcdef", 1, 12), ("pen", 1, 13), ("cdefg", 1, 14), ("pen", 0, 28),
    ("bcd", 0, 24), ("abc", 1, 17), ("abcd", 1, 18), ("abcde", 0, 26),
    ("bcde", 1, 20), ("cde", 1, 21), ("cd", 1, 22), ("bc", 1, 23),
    ("u", 1, 24), ("uu", 1, 25),
]

TEXT = "He found his pencil, but she could not find hers (Hi! Ushers !! --abcdefgh--)"


def case_insensitive_key(ch):
    # the reference's alphacmp (generic_test.c:48-54)
    return ch.lower()


def build_machine(incremental):
    m = ac.Machine(key_fn=case_insensitive_key, incremental=incremental)
    cur = m.initiate()
    for index, (kw, check, total) in enumerate(LIST_OF_KEYWORDS):
        for ch in kw:
            m.insert_letter_of_keyword(cur, ch)
        val = [index]
        prev = m.insert_end_of_keyword(cur, val)
        # Duplicate-insert protocol (ref h:59-64, generic_test.c:113-117):
        # first insertion returns None and adopts the value; re-insertion
        # returns the prior value and the caller merges.
        assert (prev is None) == bool(check)
        if prev is not None:
            prev[0] += val[0]
        assert (prev if prev is not None else val)[0] == total
    return m


def brute_force_matches(keywords, text, key):
    """(start, keyword) set oracle, case-folded, overlapping occurrences."""
    folded = [key(c) for c in text]
    out = set()
    for kw in keywords:
        fkw = [key(c) for c in kw]
        for i in range(len(text) - len(kw) + 1):
            if folded[i:i + len(kw)] == fkw:
                out.add((i, kw))
    return out


DISTINCT = sorted({kw for kw, _, _ in LIST_OF_KEYWORDS})


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["meyer85", "ac75"])
def test_paper_graph(incremental):
    m = build_machine(incremental)
    assert m.nb_keywords() == 21

    # Enumeration: every distinct keyword exactly once, comparator order
    # (DFS over key-sorted transitions, ref c:518).
    kws = [match.text() for match in m.keywords()]
    assert sorted(kws) == DISTINCT
    assert kws == sorted(kws)  # single-case alphabet here -> plain sort

    # Associated values survive with the merge results.
    by_kw = {match.text(): match.value for match in m.keywords()}
    assert by_kw["hers"] == [14]
    assert by_kw["hen"] == [21]
    assert by_kw["pen"] == [28]
    assert by_kw["bcd"] == [24]
    assert by_kw["abcde"] == [26]
    assert by_kw["he"] == [0]
    # "she" got value [1] at first insertion
    assert by_kw["she"] == [1]

    # Trie dump runs and checks internal invariants (ref c:562,578-579).
    buf = io.StringIO()
    m.print(buf)
    dump = buf.getvalue()
    assert "(000)" in dump and "-->" in dump and "[+" in dump

    expected = brute_force_matches(DISTINCT, TEXT, case_insensitive_key)

    # Host streaming path.
    cur = m.initiate()
    got = set()
    for i, ch in enumerate(TEXT):
        n = m.match(cur, ch)
        lengths = []
        for j in range(n):
            mt = m.get_match(cur, j)
            got.add((i - mt.length + 1, mt.text().lower()))
            lengths.append(mt.length)
        # index 0 = longest; strictly decreasing along the fail chain
        assert lengths == sorted(lengths, reverse=True)
    expected_lower = {(s, k.lower()) for s, k in expected}
    assert got == expected_lower

    # Dense device path.
    scanner = m.scanner(n_streams=8)
    got_dense = {(match.text().lower(), ev.start)
                 for ev, match in scanner.find_matches(TEXT)}
    assert got_dense == {(k, s) for s, k in expected_lower}
    assert scanner.count(TEXT) == len(expected)


def test_case_insensitive_representative_signs():
    """The first-seen sign is the representative (edge keeps the first
    inserted letter, ref c:305-307): keywords inserted uppercase are
    reported uppercase."""
    m = ac.Machine(key_fn=case_insensitive_key)
    m.insert_keyword("He")
    cur = m.initiate()
    assert m.match(cur, "h") == 0
    assert m.match(cur, "E") == 1
    assert m.get_match(cur, 0).text() == "He"


def test_insert_end_requires_letter():
    """acm_insert_end_of_keyword on a virgin cursor is a precondition
    violation (ref c:345). The reference kills the thread (ACM_ASSERT);
    we raise."""
    m = ac.Machine()
    cur = m.initiate()
    with pytest.raises(ValueError):
        m.insert_end_of_keyword(cur)
