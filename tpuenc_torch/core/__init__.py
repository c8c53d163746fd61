"""core subpackage (copies of tpuenc.core: pure Python and numpy)."""
