"""Kernel library of the port (counterpart of ``fusion_sim_tpu.ops``)."""
