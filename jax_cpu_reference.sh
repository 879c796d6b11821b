#!/bin/sh
# The JAX package's CPU runs that chip_smoke.py phase 8 holds the port to:
# galaxy_rbf, logit_centered, synth_quick and flat_mlp through the JAX
# package's train.py, each with the .prms that chip_smoke.config_text
# writes (SEED pinned, flat_mlp cut to 2 epochs), then galaxy_rbf for 3
# epochs at each SEED of chip_smoke.GALAXY_SWEEP. Prints each run's epoch
# table; chip_smoke.CONFIGS and GALAXY_SWEEP_JAX hold the numbers.
#
#   sh jax_cpu_reference.sh [output directory, default jax_cpu_reference]
set -e
repo=$(cd "$(dirname "$0")" && pwd)
out=${1:-jax_cpu_reference}
mkdir -p "$out"
cd "$out"

run() {   # dataset, config name, file stem, config_text arguments
  PYTHONPATH="$repo" python -c "import chip_smoke, sys; \
sys.stdout.write(chip_smoke.config_text($4))" > "$3.prms"
  PYTHONPATH="$repo" JAX_PLATFORMS=cpu python "$repo/train.py" "$1" \
    "$3.prms" > "$3.out" 2> "$3.err"
  echo "== $3 on $1"
  grep -E '^Epoch|^ *[0-9]+ +[0-9.]+ +' "$3.out"
}

for pair in "synth3 galaxy_rbf" "synth logit_centered" "synth synth_quick" \
            "synth_hard flat_mlp"; do
  set -- $pair
  run "$1" "$2" "$2" "'$2'"
done
seeds=$(PYTHONPATH="$repo" python -c "import chip_smoke; \
print(*chip_smoke.GALAXY_SWEEP)")
epochs=$(PYTHONPATH="$repo" python -c "import chip_smoke; \
print(chip_smoke.GALAXY_SWEEP_EPOCHS)")
for s in $seeds; do
  run synth3 galaxy_rbf "galaxy_rbf_seed$s" "'galaxy_rbf', $s, $epochs"
done
