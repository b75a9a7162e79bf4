"""The seeded synthetic corpus (utils/corpus.py) behind bench.py and
chip_smoke.py: deterministic per seed, exactly the requested size, the
stated alphabet, and a dictionary of its most frequent words."""

from collections import Counter

import numpy as np

from aho_corasick_1975_tpu.utils import corpus


def test_deterministic_per_seed():
    a = corpus.generate(1 << 16, n_keywords=50, seed=3)
    b = corpus.generate(1 << 16, n_keywords=50, seed=3)
    c = corpus.generate(1 << 16, n_keywords=50, seed=4)
    assert a.text == b.text and a.keywords == b.keywords
    assert a.text != c.text
    assert (a.seed, a.n_types, a.zipf_s) == (3, corpus.N_TYPES,
                                             corpus.ZIPF_S)


def test_size_and_alphabet():
    for n in (1, 1000, (1 << 18) + 7):
        c = corpus.generate(n, n_keywords=10)
        assert len(c.text) == n
        used = set(np.unique(np.frombuffer(c.text, np.uint8)).tolist())
        assert used <= set(range(ord("a"), ord("z") + 1)) | {ord(" ")}
    assert b"  " not in c.text and c.text[0:1] != b" "


def test_keywords_are_the_most_frequent_words():
    c = corpus.generate(2 << 20, n_keywords=1000)
    assert len(c.keywords) == len(set(c.keywords)) == 1000
    assert all(w.isalpha() and w.islower() for w in c.keywords)
    counts = Counter(c.text.split()[:-1])    # the last token may be cut
    top = [w for w, _ in counts.most_common(10)]
    assert set(top) == set(c.keywords[:10])
    # Zipfian: the dictionary covers most tokens, as in English
    covered = sum(counts[w] for w in c.keywords)
    assert 0.6 < covered / sum(counts.values()) < 0.8
