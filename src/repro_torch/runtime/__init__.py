"""Training-side fault tolerance (src/repro/runtime/): heartbeats, straggler
detection, elastic re-mesh and the step guard."""
