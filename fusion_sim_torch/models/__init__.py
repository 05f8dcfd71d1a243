"""Simulation models of the port (counterpart of ``fusion_sim_tpu.models``)."""
