# Developer entry points (role parity with the reference Makefile).

.PHONY: test test-fast test-native test-cpp bench native clean lint dryrun demo

test:            ## full suite (CPU, float64 parity mode, 8 virtual devices)
	python -m pytest tests/ -q

test-fast:       ## fast tier: skips the slow-marked multi-device / bench-smoke tests (~4.5 min on 1 CPU core vs ~8 min full)
	python -m pytest tests/ -q -m "not slow"

test-native:     ## native C++ host runtime only
	python -m pytest tests/test_native.py -q

native:          ## build the C++ host library
	python -c "from pde_tpu.native import build; print(build(force=True))"

test-cpp:        ## native C++ unit tests (role parity with the reference GTest suites)
	mkdir -p build
	g++ -O2 -march=native -std=c++17 -pthread src/cpp/pde_host.cpp src/cpp/pde_solvers.cpp \
		src/cpp/pde_host_test.cpp -o build/pde_host_test
	./build/pde_host_test

bench:           ## headline benchmark (needs an NVIDIA GPU)
	python bench.py

dryrun:          ## multi-chip sharding dry run on an 8-device virtual mesh
	JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

demo:            ## end-to-end calibrate -> signal -> backtest demo
	python -m pde_tpu.cli demo

clean:
	rm -rf build/ .pytest_cache/ **/__pycache__/
