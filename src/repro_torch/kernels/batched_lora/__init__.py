"""BGMV: per-row adapter gather for mixed-tenant serving."""
