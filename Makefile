# DOTs-SOCP-TPU replication harness. Mirrors the reference Makefile targets:
#   make main       - comparison sweep (14 examples x 3 congestion levels)
#   make true_error - accuracy vs the exact transport on the plane example
#   make test       - unit + golden test suite
#   make bench      - GPU throughput benchmark (one JSON line)
#   make smoke      - one pass of the main path on the GPU (chip_smoke.py)
PYTHON ?= python
# The main recipe uses ${var//./_} substitutions: require bash, not /bin/sh.
SHELL := /bin/bash
# Append, don't clobber: the environment may register JAX backend plugins
# through PYTHONPATH.
export PYTHONPATH := ./:$(PYTHONPATH)
export PYTHONIOENCODING := utf-8

OUTDIR := output/$(shell date +%Y_%m%d_%H%M)

.DEFAULT_GOAL := help

help:
	@echo "======= DOTs-SOCP-TPU ======="
	@echo ""
	@echo "Benchmark"
	@echo "------------------------------------"
	@echo "  make main        - Run the main comparison experiments (tables)"
	@echo "  make true_error  - Compare against the exact transportation"
	@echo "  make test        - Run the test suite"
	@echo "  make bench       - GPU throughput benchmark"
	@echo "  make smoke       - Main path once on the GPU, checked"
	@echo ""
	@echo "Environment Variables"
	@echo "------------------------------------"
	@echo "  tol=<tolerance>  - Tolerance for main experiments (default: $(tol))"
	@echo ""

.PHONY: help main true_error test bench smoke

# =======================================
# Comparison table of numerical experiments
# =======================================
OUTDIR_MAIN := $(OUTDIR)_main
tol ?= 1e-4
time_limit ?= 5000

EXAMPLES = airplane 		refined_airplane \
		   armadillo 		refined_armadillo \
		   hand 			refined_hand \
		   punctured_ball 	refined_punctured_ball \
		   bunny 			refined_bunny \
		   ring knots_3 knots_5 hills
CONGESTIONs = 0.00 0.01 0.05

# One in-process sweep instead of one process per run: meshes are padded
# into shared shape buckets so XLA compiles one solver graph per bucket,
# a warmup absorbs each compile outside the measured runs, and each run's
# table row carries a Converged annotation (yes | time-capped). Same
# outputs as the reference's per-process loop: per-congestion info.log +
# comparison_table.{tex,html}.
main:
	@mkdir -p "$(OUTDIR_MAIN)"
	$(PYTHON) replication/sweep.py --ntime=31 --nit=10000 \
		--time_limit=$(time_limit) --tol=$(tol) --outdir=$(OUTDIR_MAIN) \
		--congestions $(CONGESTIONs) --examples $(EXAMPLES)

# =======================================
# Error versus exact transportation
# =======================================
OUTDIR_TRUE_ERROR := $(OUTDIR)_true_error

true_error:
	@mkdir -p "$(OUTDIR_TRUE_ERROR)"
	@$(PYTHON) replication/main_versus_exact.py \
		--example=plane \
		--n_space=50 \
		--tol=0.00001 \
		--nit=20000 \
		--precision=float64 \
		--save \
		--outdir=$(OUTDIR_TRUE_ERROR) \
		--log_file="$(OUTDIR_TRUE_ERROR)/info.log";

test:
	$(PYTHON) -m pytest tests/ -x -q

bench:
	$(PYTHON) bench.py

smoke:
	$(PYTHON) chip_smoke.py

all: main true_error
.PHONY: all
