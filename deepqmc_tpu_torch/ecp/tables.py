"""The ECP tables packaged with the JAX package (``deepqmc_tpu/ecp/tables/``),
as GAMESS-US text: ``TABLES[ecp_type][symbol]`` the default tables and
``REFIT_TABLES`` the opt-in in-house refits of ``tables/refit/``.  Their
provenance and verification status are in ``deepqmc_tpu/ecp/tables/README.md``:
ccECP (C, O, N, Li) and BFD (C, Li) parameters as published, an in-house LDA
refit of N on request, and for Sc an in-house LDA refit, not the published
file (marked ``IN-HOUSE`` in its text, which makes the loader warn).  The
files' comment lines are left out; the parameters are theirs, digit for
digit."""

TABLES = {
    'bfd': {
        'C': '''\
C-bfd GEN 2 1
3
4.00000000 1 8.35973821
33.44388280 3 4.48361888
-19.17537323 2 3.93831258
1
22.55164191 2 5.02991637
''',
        'Li': '''\
Li-bfd GEN 2 1
3
1.00000000 1 7.90000000
7.90000000 3 3.90000000
-3.00000000 2 3.00000000
1
10.00000000 2 5.00000000
''',
    },
    'ccECP': {
        'C': '''\
C-ccECP GEN 2 1
3
4.00000000 1 14.43502000
57.74008000 3 8.39889000
-25.81955000 2 7.38188000
1
52.13345000 2 7.76079000
''',
        'Li': '''\
Li-ccECP GEN 2 1
3
1.00000000 1 6.51479055
6.51479055 3 4.50667058
-11.01771083 2 4.38186107
1
14.86086671 2 5.53297711
''',
        'N': '''\
N-ccECP GEN 2 1
3
5.00000000 1 9.23501000
46.17505000 3 7.66830000
-30.18893000 2 7.34486000
1
77.74203000 2 9.78499000
''',
        'O': '''\
O-ccECP GEN 2 1
3
6.00000000 1 12.30997000
73.85984000 3 14.76962000
-47.87600000 2 13.71419000
1
85.86406000 2 13.65512000
''',
        'Sc': '''\
# IN-HOUSE LDA-REFIT table (not the published ccECP file)
Sc-ccECP GEN 10 2
4
11.00000000 1 9.00690130
99.07591435 3 11.94004339
-18.33471532 2 4.48403847
0.28887133 2 1.27110342
3
124.98815242 2 9.92302765
74.99365455 2 8.71203090
0.01536327 2 4.69558426
2
7.62870932 2 1.39180193
-0.75106202 2 0.23631093
''',
    },
}

REFIT_TABLES = {
    'ccECP': {
        'N': '''\
# IN-HOUSE LDA-REFIT table (not the published ccECP file)
N-ccECP GEN 2 1
3
5.00000000 1 9.20192638
46.00963192 3 7.28251990
-30.19438720 2 7.05451515
1
77.74046605 2 11.07130538
''',
    },
}
