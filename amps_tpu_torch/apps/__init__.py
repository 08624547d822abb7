"""Operator applications of the port: the BS-in-a-box station
(``bs_app``) and the RECC capture monitor (``recc_monitor``)."""
