#!/bin/sh
# The JAX package's CPU runs that chip_smoke.py phases 8 and 12 hold the
# port to: galaxy_rbf, logit_centered, synth_quick and flat_mlp through the
# JAX package's train.py, each with the .prms that chip_smoke.config_text
# writes (SEED pinned, flat_mlp cut to 2 epochs), then galaxy_rbf for 3
# epochs at each SEED of chip_smoke.GALAXY_SWEEP, then the per-layer slice
# (mnist_cnn with FUSED_TAIL and 'method': 'pallas', chip_smoke.slice_text)
# for SLICE_EPOCHS + 1 epochs. Prints each run's epoch table;
# chip_smoke.CONFIGS, GALAXY_SWEEP_JAX and SLICE_JAX hold the numbers.
#
#   sh jax_cpu_reference.sh [output directory, default jax_cpu_reference]
set -e
repo=$(cd "$(dirname "$0")" && pwd)
out=${1:-jax_cpu_reference}
mkdir -p "$out"
cd "$out"

run() {   # dataset, file stem, the chip_smoke call that writes the .prms
  PYTHONPATH="$repo" python -c "import chip_smoke, sys; \
sys.stdout.write(chip_smoke.$3)" > "$2.prms"
  PYTHONPATH="$repo" JAX_PLATFORMS=cpu python "$repo/train.py" "$1" \
    "$2.prms" > "$2.out" 2> "$2.err"
  echo "== $2 on $1"
  grep -E '^Epoch|^ *[0-9]+ +[0-9.]+ +' "$2.out"
}

for pair in "synth3 galaxy_rbf" "synth logit_centered" "synth synth_quick" \
            "synth_hard flat_mlp"; do
  set -- $pair
  run "$1" "$2" "config_text('$2')"
done
seeds=$(PYTHONPATH="$repo" python -c "import chip_smoke; \
print(*chip_smoke.GALAXY_SWEEP)")
epochs=$(PYTHONPATH="$repo" python -c "import chip_smoke; \
print(chip_smoke.GALAXY_SWEEP_EPOCHS)")
for s in $seeds; do
  run synth3 "galaxy_rbf_seed$s" "config_text('galaxy_rbf', $s, $epochs)"
done
run synth_hard mnist_cnn_slice \
  "slice_text(chip_smoke.SLICE_EPOCHS + 1)"
