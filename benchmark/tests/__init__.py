"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the checkout. They run on the CPU; the cases marked ``gpu`` need a
CUDA device and skip without one."""
