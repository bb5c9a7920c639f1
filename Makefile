# mazu_tpu build/test/bench entry points

.PHONY: native test test-fast bench smoke clean

native:
	python -c "from mazu_tpu.io.native import have_native, library_path; assert have_native(); print(library_path())"

test: native
	python -m pytest tests/ -q

test-fast: native
	python -m pytest tests/ -q -m "not slow"

bench:
	python bench.py

smoke:
	python chip_smoke.py

clean:
	rm -rf native/build
	find . -name __pycache__ -type d -exec rm -rf {} +
