# Native-code hygiene targets (SURVEY.md §5: the reference builds plain
# Release with no sanitizers; here the host C++ gets ASan/UBSan coverage).

NATIVE := bioseqdb_tpu/index/native

.PHONY: test native-sanitize clean

# per-file pytest processes (tools/run_tests.py): single-process pytest
# segfaults the XLA-CPU compiler at suite scale (~6 GB RSS)
test:
	python tools/run_tests.py

# Build the native library under ASan+UBSan and run the native test
# driver against it (SA-IS vs random oracles + ksw_global cases).
native-sanitize:
	g++ -O1 -g -std=c++17 -fopenmp -fsanitize=address,undefined \
	    -fno-sanitize-recover=all \
	    -o /tmp/native_sanitize_check $(NATIVE)/sais.cpp $(NATIVE)/ksw.cpp \
	    $(NATIVE)/finalize1.cpp tools/native_check.cpp
	/tmp/native_sanitize_check

clean:
	rm -f $(NATIVE)/libbst_native.*.so
	rm -rf .jax_cache
