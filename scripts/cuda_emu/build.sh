#!/bin/bash
# Build kernel sources of mpnn_tpu_torch/csrc/ for the CPU stand-in of the
# CUDA runtime (scripts/cuda_emu/cuda_runtime.h), with g++ and no nvcc:
#
#   scripts/cuda_emu/build.sh NAME:ARGS [NAME:ARGS ...]
#
# NAME is a source csrc/NAME.cu with a cooperative launch, ARGS the type of
# its kernel's one argument struct (fused_att_steps_fwd:FwdArgs). Each
# becomes mpnn_tpu_torch/_build/emu/libmpnn_NAME.so, with the same C entry
# points as the card's library, under AddressSanitizer when ASAN=1 (then
# run Python with LD_PRELOAD=$(g++ -print-file-name=libasan.so)).
set -euo pipefail
here=$(cd "$(dirname "$0")" && pwd)
repo=$(cd "$here/../.." && pwd)
out="$repo/mpnn_tpu_torch/_build/emu"
rm -rf "$out/src" && mkdir -p "$out/src"
cp "$repo"/mpnn_tpu_torch/csrc/*.cu "$repo"/mpnn_tpu_torch/csrc/*.cuh "$out/src/"
# dynamic shared memory comes from the emulated block
sed -i -E 's/extern __shared__ float ([a-z_]+)\[\];/float* \1 = (float*)emu_smem();/' \
    "$out"/src/*.cu "$out"/src/*.cuh
flags=(-std=c++20 -O2 -g -shared -fPIC)
if [ "${ASAN:-0}" = 1 ]; then
  flags+=(-fsanitize=address -fno-omit-frame-pointer)
fi
pids=()
for spec in "$@"; do
  name=${spec%%:*}
  args=${spec#*:}
  printf '#include "%s.cu"\nstatic struct EmuInit { EmuInit() { emu_runner = &emu_run<%s>; } } emu_init_;\n' \
      "$name" "$args" > "$out/src/emu_$name.cpp"
  g++ "${flags[@]}" -I"$here" -I"$out/src" -o "$out/libmpnn_$name.so" \
      "$out/src/emu_$name.cpp" -lpthread &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done
ls "$out"/*.so
