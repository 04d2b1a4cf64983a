#!/usr/bin/env bash
# Snapshot gate (CPU): the graft entry, the 8-device multichip dry run,
# bench --quick and the smoke test tier. Exits non-zero on any failure.
# The GPU counterpart is `python chip_smoke.py` on a machine with a card.
#
# Usage: tools/gate.sh [--full]   (--full also runs the slow test tier)
set -u
cd "$(dirname "$0")/.."
fail=0

step() {  # step <name> <cmd...>
  local name=$1; shift
  echo "== gate: $name"
  if "$@"; then echo "== gate: $name OK"; else echo "== gate: $name FAILED"; fail=1; fi
}

step entry timeout 600 python -c "
import __graft_entry__ as g, jax
fn, args = g.entry()
jax.block_until_ready(jax.jit(fn)(*args))
print('entry ok')
"

step multichip env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  timeout 600 python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)
"

step bench-quick timeout 900 python bench.py --quick

step test-smoke timeout 900 python -m pytest tests/ -x -q -m "not slow"

if [ "${1:-}" = "--full" ]; then
  step test-slow timeout 3600 python -m pytest tests/ -q -m "slow"
fi

if [ $fail -ne 0 ]; then echo "GATE RED"; exit 1; fi
echo "GATE GREEN"
