"""Plans, stage IR, fusion, compiler, planner and streaming executor of the port."""
