"""The C ABI (mjpc_capi.cc), its smoke test and their build (build.py)."""
