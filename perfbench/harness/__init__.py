"""The benchmark's machinery shared by every driver."""
