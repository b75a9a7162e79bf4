"""Seeded synthetic English-like corpus for benchmarks and smoke runs.

The headline deployment scans normalised English prose (lowercase letters
and spaces) against a dictionary of its own 1,000 most frequent words. No
prose ships with the package, so this module generates text of that shape
from a seed:

* ``n_types`` distinct word types; each word's letters follow English
  letter frequencies, and its length grows with its frequency rank, as in
  English (frequent words are short);
* tokens are drawn from a Zipf law over the ranks (exponent ``zipf_s``),
  which with the defaults puts ~70% of tokens among the 1,000 most frequent
  types — the coverage English shows;
* tokens are joined by single spaces and the text is cut to exactly the
  requested byte length.

Everything is a pure function of the seed and the arguments.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

SEED = 1975
N_TYPES = 20_000
ZIPF_S = 1.0

# Relative letter frequencies of English text, a..z (per 100,000 letters).
_LETTER_FREQ = np.array([
    8167, 1492, 2782, 4253, 12702, 2228, 2015, 6094, 6966, 153, 772, 4025,
    2406, 6749, 7507, 1929, 95, 5987, 6327, 9056, 2758, 978, 2360, 150,
    1974, 74], np.float64)


class Corpus(NamedTuple):
    text: bytes            # lowercase a-z and spaces, exactly n_bytes long
    keywords: List[bytes]  # the most frequent words, most frequent first
    seed: int
    n_types: int
    zipf_s: float


def word_types(n_types: int = N_TYPES, seed: int = SEED) -> List[bytes]:
    """``n_types`` distinct lowercase words, most frequent rank first."""
    rng = np.random.default_rng([seed, 0])
    p = _LETTER_FREQ / _LETTER_FREQ.sum()
    seen, out = set(), []
    r = 0
    while len(out) < n_types:
        mean = 0.6 + 0.45 * np.log2(r + 2)
        n = max(1, int(round(mean + rng.normal(0.0, 1.2))))
        w = (rng.choice(26, size=n, p=p) + ord("a")).astype(np.uint8)
        w = w.tobytes()
        if w not in seen:
            seen.add(w)
            out.append(w)
            r += 1
    return out


def generate(n_bytes: int, n_keywords: int = 1000, seed: int = SEED,
             n_types: int = N_TYPES, zipf_s: float = ZIPF_S) -> Corpus:
    """``n_bytes`` of Zipfian text and its ``n_keywords`` most frequent
    words (ties broken by the word's bytes)."""
    words = word_types(n_types, seed)
    lens = np.array([len(w) + 1 for w in words], np.int64)  # + space
    pool = np.frombuffer(b"".join(w + b" " for w in words), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    p = 1.0 / np.arange(1, n_types + 1, dtype=np.float64) ** zipf_s
    p /= p.sum()
    rng = np.random.default_rng([seed, 1])
    counts = np.zeros(n_types, np.int64)
    parts, have = [], 0
    mean_tok = float((p * lens).sum())
    while have < n_bytes:
        n_tok = int((n_bytes - have) / mean_tok) + 64
        idx = rng.choice(n_types, size=n_tok, p=p)
        tl = lens[idx]
        total = int(tl.sum())
        starts = np.repeat(offs[idx] - (np.cumsum(tl) - tl), tl)
        parts.append(pool[starts + np.arange(total)])
        counts += np.bincount(idx, minlength=n_types)
        have += total
    text = np.concatenate(parts)[:n_bytes].tobytes()
    order = sorted(range(n_types), key=lambda i: (-counts[i], words[i]))
    keywords = [words[i] for i in order[:n_keywords]]
    return Corpus(text, keywords, seed, n_types, zipf_s)
