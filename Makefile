# kvzip build/test entry points (reference has `make i`; here:)

.PHONY: install native test bench clean

install: native
	pip install -e .

native:
	$(MAKE) -C csrc

test:
	python -m pytest tests/ -q  # xdist-sharded via pyproject addopts

bench:
	python bench.py

clean:
	$(MAKE) -C csrc clean
