"""Companion tools of the port, copies of racon_tpu/tools: sampler
(rampler equivalent), paired-end preprocessor, and the wrapper CLI, which
polishes through the port's Polisher (reference: vendor/rampler,
scripts/racon_preprocess.py, scripts/racon_wrapper.py)."""
