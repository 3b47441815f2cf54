-- Waveform-simulation parameter-sweep schema (a copy of WFParams.sql at the repository root).
-- param_set: one row per simulated waveform parameter set;
-- curve_diffs: per-segment normalized differences between each set's
-- simulated calibration curves and a reference calibration.
CREATE TABLE param_set
(
    id INTEGER CONSTRAINT param_set_pk PRIMARY KEY AUTOINCREMENT,
    name STRING UNIQUE NOT NULL,
    PE_per_MeV FLOAT DEFAULT 1200 NOT NULL,
    gain FLOAT DEFAULT -5000,
    PMT_sigma_t FLOAT DEFAULT 3,
    lambda FLOAT DEFAULT 1775,
    n FLOAT DEFAULT 1.6,
    zoff FLOAT DEFAULT 0,
    x_crit FLOAT DEFAULT 0,
    lambda_s FLOAT DEFAULT 0,
    eta_bar FLOAT DEFAULT 1,
    PMT_decay_proportion_1 FLOAT DEFAULT 0.6,
    PMT_decay_proportion_2 FLOAT DEFAULT 0.4,
    PMT_decay_tau_1 FLOAT DEFAULT 0.5,
    PMT_decay_tau_2 FLOAT DEFAULT 16,
    PSD_response_1_p1 FLOAT DEFAULT 0.7,
    PSD_response_1_p2 FLOAT DEFAULT 0.28,
    PSD_response_1_p3 FLOAT DEFAULT 0.02,
    PSD_response_1_tau1 FLOAT DEFAULT 3.16,
    PSD_response_1_tau2 FLOAT DEFAULT 32.3,
    PSD_response_1_tau3 FLOAT DEFAULT 270,
    PSD_response_2_p1 FLOAT DEFAULT 0.3,
    PSD_response_2_p2 FLOAT DEFAULT 0.65,
    PSD_response_2_p3 FLOAT DEFAULT 0.05,
    PSD_response_2_tau1 FLOAT DEFAULT 3.16,
    PSD_response_2_tau2 FLOAT DEFAULT 32.3,
    PSD_response_2_tau3 FLOAT DEFAULT 270
);

CREATE TABLE curve_diffs (
    id INTEGER NOT NULL,
    param_set_id INTEGER NOT NULL,
    calname STRING NOT NULL,
    seg INTEGER NOT NULL,
    normed_diff FLOAT,
    psd_nd0 FLOAT,
    psd_nd1 FLOAT,
    att_nd0 FLOAT,
    att_nd1 FLOAT,
    t_nd0 FLOAT,
    t_nd1 FLOAT,
    PRIMARY KEY (id),
    UNIQUE (calname, seg, param_set_id),
    FOREIGN KEY(param_set_id) REFERENCES param_set (id)
);
