"""racon_tpu_torch: the PyTorch + CUDA port of racon_tpu for NVIDIA Hopper.

The polish path (Myers overlap alignment, scored banded NW with the RLE
walk, or the packed2 walk at the widest band, inside iterative star-POA)
runs through hand-written CUDA kernels (kernels/csrc) built at first use.
The package stands alone: it keeps its own copies of the host code it
needs (io, core, the native C++ runtime, models, utils) and imports
neither jax nor racon_tpu.
"""

__version__ = "0.1.0"

# racon CLI-contract version implemented here; `--version` prints it
# (reference: CMakeLists.txt:3 sets 1.4.17, printed by src/main.cpp:143-145)
RACON_VERSION = "1.4.17"
