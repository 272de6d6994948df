"""Kernels of the port: CUDA C++ for Hopper (``csrc/``), their launchers,
the device-routed wrappers (``ops``) and the plain versions (``ref``)."""
