"""The XLA settings the port's tests give the reference code they run in a
subprocess (``conftest.run_devices``): no LLVM optimisation passes (the same
HLO, less compile time) and one Eigen thread, so that the suite's parallel
workers share the host's cores with fewer threads.  Prepend
:data:`PRELUDE` to the code; it must run before jax is imported."""

PRELUDE = """import os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true"
                            " --xla_cpu_multi_thread_eigen=false")
"""
