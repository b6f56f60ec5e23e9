"""Port of ``repro.core``: the KVDirect data path (descriptors, coalescing, connections, cluster membership, transfer engine, pull/push orchestration)."""
