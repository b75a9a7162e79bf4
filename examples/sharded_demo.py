"""Multi-chip demo: data-parallel scan over a device mesh.

Shards a corpus across all available devices, replicates the automaton
tables, exchanges shard-edge halos over ppermute and reduces the match
count with psum.

Run: python examples/sharded_demo.py          # the devices that exist
     python examples/sharded_demo.py --cpu    # 8 virtual CPU devices
"""

import os
import sys

sys.path.insert(0, ".")

if "--cpu" in sys.argv[1:]:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.parallel.mesh import make_mesh
from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner


def main():
    print(f"devices: {jax.devices()}")
    m = ac.Machine()
    for kw in ["needle", "haystack", "spanner"]:
        m.insert_keyword(kw)

    rng = np.random.default_rng(0)
    words = ["needle", "haystack", "spanner", "filler", "noise", "words"]
    text = " ".join(rng.choice(words) for _ in range(200_000))

    mesh = make_mesh()
    scanner = ShardedScanner(m, mesh)
    total = scanner.count(text)
    print(f"{total} matches across {mesh.shape} mesh "
          f"(corpus {len(text):,} chars)")

    # positions survive sharding: decode from the sharded states
    from aho_corasick_1975_tpu.ops.decode import decode_matches
    events = decode_matches(scanner.scan_states(text[:5000]), scanner.tables)
    print("first events:", [(ev.start, m.match_for_state(ev.end_state).text())
                            for ev in events[:5]])


if __name__ == "__main__":
    main()
