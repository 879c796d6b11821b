#!/bin/sh
# The JAX package's CPU runs that chip_smoke.py phases 8 and 12 hold the
# port to: galaxy_rbf, logit_centered, synth_quick and flat_mlp through the
# JAX package's train.py, each with the .prms that chip_smoke.config_text
# writes (SEED pinned, flat_mlp cut to 2 epochs), then galaxy_rbf for 3
# epochs at each SEED of chip_smoke.GALAXY_SWEEP, then the per-layer slice
# (mnist_cnn with FUSED_TAIL and 'method': 'pallas', chip_smoke.slice_text)
# for SLICE_EPOCHS + 1 epochs, then params/synth_aux.prms as shipped (phase
# 20), then mnist_cnn's layers with both convs 'same' on synth_hard
# (chip_smoke.geometry_text("mnist_same"), phase 22); last, the eval-mode
# mean NLL of bench.py's wide model (chip_smoke.wide_spec, wide_data) on
# its first batch at the initial weights, bf16 and f32, conv2 through the
# Pallas conv (THEANET_PALLAS_CONV=1). Prints each run's epoch table and
# the two NLLs; chip_smoke.CONFIGS, GALAXY_SWEEP_JAX, SLICE_JAX, AUX_JAX,
# GEOM_JAX and WIDE_NLL_JAX hold the numbers.
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
PYTHONPATH="$repo" JAX_PLATFORMS=cpu python "$repo/train.py" synth_aux \
  "$repo/params/synth_aux.prms" > synth_aux.out 2> synth_aux.err
echo "== synth_aux on synth_aux (as shipped; AUX_JAX)"
grep -E '^Epoch|^ *[0-9]+ +[0-9.]+ +' synth_aux.out
run synth_hard mnist_same "geometry_text('mnist_same')"
echo "== wide model: initial eval NLL of the first batch (WIDE_NLL_JAX)"
PYTHONPATH="$repo" JAX_PLATFORMS=cpu THEANET_PALLAS_CONV=1 python -c "
import jax, jax.numpy as jnp, chip_smoke as cs
from theanet_tpu.model import NeuralNet
x, y = cs.wide_data()
for dt in ('bfloat16', 'float32'):
    net = NeuralNet(*cs.wide_spec(dt))
    params, _ = net.init_params()
    hs = net.forward(params, jnp.asarray(x[:cs.WIDE_B]),
                     key=jax.random.PRNGKey(0), train=False)
    print(dt, float(net.head.cost(hs, jnp.asarray(y[:cs.WIDE_B]))))
"
