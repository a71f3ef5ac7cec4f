# Convenience targets; the package itself needs no build step (the
# native tier builds on demand via raytracinginoneweekend_tpu/native).

.PHONY: test gate bench smoke

# Fast tier on the virtual 8-device CPU mesh (xdist).
test:
	./run_tests.sh

# Pre-snapshot ritual: FULL tier incl. the slow oracle /
# external-parity tests; records the tally + HEAD + dirty flag to
# docs/TESTS_r$(ROUND).json so the snapshot commit provably follows a
# green full run. Fails if the tier fails.
ROUND ?= 05
gate:
	ROUND=$(ROUND) sh scripts/gate.sh

# Headline bench (needs a GPU).
bench:
	python bench.py

# Smoke check of render, fit and serve on one GPU.
smoke:
	python chip_smoke.py
