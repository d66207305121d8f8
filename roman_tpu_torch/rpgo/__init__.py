"""Robust pose-graph optimization: the back half of the demo (port of
roman_tpu/rpgo)."""
