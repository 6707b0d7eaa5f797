"""Replay: host buffers, the device-resident replay window and the host-to-device feed."""
