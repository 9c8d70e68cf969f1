"""Retrieval prediction, results files and Recall@K."""
