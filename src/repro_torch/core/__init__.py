"""Plans, stage IR, fusion, compiler and streaming executor of the port."""
