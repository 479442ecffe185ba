"""The runtime core: op graph, planner, engine, pipeline, scheduler."""
