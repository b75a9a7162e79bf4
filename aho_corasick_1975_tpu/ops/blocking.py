"""Halo-overlap blocking: sequence parallelism for the automaton scan.

The reference scans strictly sequentially, one symbol per call (acm_match,
aho_corasick.c:433-448). The device design exploits a structural property of the
Aho–Corasick automaton instead of translating that loop:

    The state after consuming position t is, by construction, the longest
    suffix of text[0..t] that is a prefix of some keyword. Its length is at
    most D = max trie depth = max keyword length. Hence the state at t is a
    function of text[t-D+1..t] only: a scan started from the ROOT at any
    position p <= t - D reaches the true state by position t.

So a stream splits into B blocks of L symbols, each prefixed by a halo of
H >= D symbols re-run from the previous block (discarding halo outputs), and
all blocks advance independently — the moral equivalent of context/sequence
parallelism for DFA scanning (SURVEY.md §5). The same construction handles
shard boundaries across chips (parallel/sharded_scan.py), with the halo
fetched from the left-neighbor device via ppermute.

Everything here is host-side numpy layout code; no device math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

OOV = 0


def block_time_major(ids: np.ndarray, block_len: int, halo: int,
                     head: np.ndarray = None) -> Tuple[np.ndarray, int]:
    """Lay out a stream as a time-major [halo+L, B] block matrix.

    Block b covers ids[b*L:(b+1)*L], prefixed by the previous H symbols
    (OOV-padded at the stream head — OOV self-loops on the root, so the
    warm-up from the root is exact). The tail block is OOV-padded; padded
    positions land on the root, whose output count is 0 (the root can never
    be an end-of-keyword: insert_end on the root is rejected, ref c:345), so
    padding never contributes matches.

    ``head``: optional ids preceding the stream (<= halo of them) — the
    cross-chunk carry of a StreamSession or a neighbor shard's tail; placed
    immediately before position 0 in the first block's halo.

    Returns (blocks_tm int32 [halo+L, B], n_blocks).
    """
    T = len(ids)
    L = int(block_len)
    H = int(halo)
    B = max(1, -(-T // L))
    padded = np.zeros(B * L + H, dtype=np.int32)
    padded[H:H + T] = ids
    if head is not None and len(head) and H:
        h = min(len(head), H)
        padded[H - h:H] = head[-h:]
    # window b = padded[b*L : b*L + H + L]  (strided view, no copy)
    itemsize = padded.strides[0]
    windows = np.lib.stride_tricks.as_strided(
        padded, shape=(B, H + L), strides=(L * itemsize, itemsize))
    return np.ascontiguousarray(windows.T), B


def unblock_states(states_tm: np.ndarray, halo: int, T: int) -> np.ndarray:
    """Invert block_time_major for per-position state outputs.

    states_tm: [halo+L, B] device scan output. Returns states[T] in stream
    order (halo warm-up rows dropped, tail padding trimmed)."""
    body = states_tm[halo:, :]          # [L, B]
    return np.ascontiguousarray(body.T).reshape(-1)[:T]
