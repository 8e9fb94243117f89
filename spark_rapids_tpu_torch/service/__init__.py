"""The query service: today only the query scope that tags a thread
with its query id (`query_manager.py`); admission, cancellation and the
gateway come with ROADMAP A.15."""
