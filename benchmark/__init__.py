"""The benchmark of ``ssgvc_tpu_torch`` on one NVIDIA H100: its harness
(``harness/``), its plain fp32 reference (``reference/``), one adapter per
model class (``codecs/``), and the data that names its cells: one file per
configuration (``configs/``), traffic mix (``traffic/``) and per-layer
metric reader (``metrics/``). ``run.py`` is the command."""
