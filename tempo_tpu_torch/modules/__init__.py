"""The port's service modules. So far the distributor's regroup and
search-data walk (``distributor.py``); the services themselves (ring,
ingester, querier, frontend) come with the serving layer."""
