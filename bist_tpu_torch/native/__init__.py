"""The native batch-assembly core (`loader`: a C++ thread pool, built at first use, with a numpy fallback)."""
